"""The port's kernel build and binding, checked without nvcc or a GPU.

* A library's name carries the hash of its source AND of every shared
  header ``csrc/*.cuh``: editing a header renames every library (so no
  stale build is reused), editing one source renames only its own.
* Every ``extern "C"`` entry in ``csrc/*.cu`` has a ctypes argument list
  in the port (``ARGTYPES`` of ``ops/flash_attention.py``, ``ops/xent.py``
  and ``ops/launch_floor.py``) that matches its declaration parameter by
  parameter, so a C signature cannot change without its caller.
* The host library's ctypes table (``data/native.py`` ``ARGTYPES`` and
  ``RESTYPES``) matches ``native/dtm.cpp``'s ``extern "C"`` declarations
  parameter by parameter, and its name carries the hash of the source and
  the g++ flags.
* The bf16 wrappers refuse a view whose base or strides are not 16-byte
  aligned (the kernels copy 16-byte chunks with cp.async or TMA).
* ``chip_smoke.py``'s helpers: the ptxas-log reader, the tensor-core
  instruction check, the SDPA gradient that is the backward kernels'
  single-call yardstick (it computes the kernels' function), the
  row-by-row error that holds K6b's dQ, and the int8 gates of the
  serving phase, which must pass the port and fail each planted fault.
"""

import ctypes
import re
import shutil

import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.data import native
from distributed_tensorflow_ibm_mnist_tpu_torch.ops import _build
from distributed_tensorflow_ibm_mnist_tpu_torch.ops import flash_attention as fa
from distributed_tensorflow_ibm_mnist_tpu_torch.ops import launch_floor, xent

ARGTYPES = {**fa.ARGTYPES, **xent.ARGTYPES, **launch_floor.ARGTYPES}
KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_longlong: "long long",
        ctypes.c_float: "float", ctypes.POINTER(ctypes.c_longlong): "long long*"}


def _c_entries() -> dict[str, list[str]]:
    """{entry: [parameter kind, ...]} from every ``extern "C"`` declaration."""
    found = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        text = path.read_text()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            kinds = []
            for param in params.split(","):
                decl = " ".join(param.split()[:-1]).replace("const ", "")
                if "*" in param:
                    kinds.append("long long*" if "long long" in decl else "pointer")
                else:
                    kinds.append(decl)
            found[name] = kinds
    return found


def test_every_c_entry_has_an_argument_table():
    assert set(_c_entries()) == set(ARGTYPES)
    assert len(ARGTYPES) == 7  # the six kernels' entries and the empty launch_floor


@pytest.mark.parametrize("name", sorted(ARGTYPES))
def test_ctypes_arguments_match_the_c_declaration(name):
    c_kinds = _c_entries()[name]
    py_kinds = [KIND[t] for t in ARGTYPES[name]]
    assert py_kinds == c_kinds, f"{name}: ctypes {py_kinds} != C {c_kinds}"


NATIVE_KIND = {ctypes.POINTER(ctypes.c_uint8): "uint8_t*",
               ctypes.POINTER(ctypes.c_int32): "int32_t*",
               ctypes.POINTER(ctypes.c_float): "float*", ctypes.c_void_p: "void*",
               ctypes.c_int32: "int32_t", ctypes.c_int64: "int64_t",
               ctypes.c_float: "float", ctypes.c_uint64: "uint64_t", None: "void"}


def _native_entries() -> dict[str, tuple[str, list[str]]]:
    """{entry: (return kind, [parameter kind, ...])} from the definitions
    inside ``native/dtm.cpp``'s ``extern "C"`` block."""
    text = native.SOURCE.read_text()
    block = text[text.index('extern "C" {'):]
    found = {}
    for ret, name, params in re.findall(r"^(void\*?|int32_t)\s+(dtm_\w+)\(([^)]*)\)",
                                        block, re.M):
        kinds = []
        for param in params.split(","):
            decl = " ".join(param.split()[:-1]).replace("const ", "")
            kinds.append(decl.replace(" *", "*") + ("*" if param.split()[-1].startswith("*")
                                                     else ""))
        found[name] = (ret, kinds)
    return found


def test_every_native_entry_has_an_argument_table():
    assert set(_native_entries()) == set(native.ARGTYPES)
    assert len(native.ARGTYPES) == 5  # gather, render, the prefetcher's three


@pytest.mark.parametrize("name", sorted(native.ARGTYPES))
def test_native_ctypes_arguments_match_dtm_cpp(name):
    ret, c_kinds = _native_entries()[name]
    assert [NATIVE_KIND[t] for t in native.ARGTYPES[name]] == c_kinds, name
    assert NATIVE_KIND[native.RESTYPES.get(name)] == ret, name


def test_native_library_name_hashes_the_source_and_flags(tmp_path, monkeypatch):
    src = tmp_path / "dtm.cpp"
    src.write_bytes(native.SOURCE.read_bytes())
    monkeypatch.setattr(native, "SOURCE", src)
    first = native.library_path()
    assert first.parent == native.BUILD_DIR and first.name.startswith("libdtm-")
    assert native.BUILD_DIR.name == "host" and "native" not in native.BUILD_DIR.parts[-2:]
    src.write_text(src.read_text() + "\n// edited\n")
    second = native.library_path()
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + ("-g",))
    assert len({first, second, native.library_path()}) == 3


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def _paths() -> dict:
    return {name: _build.library_path(name) for name in _build.sources()}


def test_editing_a_shared_header_renames_every_library(csrc_copy):
    headers = sorted(csrc_copy.glob("*.cuh"))
    assert headers, "the kernels share at least one header"
    before = _paths()
    with headers[0].open("a") as f:
        f.write("\n// edited\n")
    after = _paths()
    assert set(before) == set(after) == {"flash_bwd", "flash_fwd", "launch_floor", "xent"}
    assert all(before[n] != after[n] for n in before)


def test_editing_one_source_renames_only_its_library(csrc_copy):
    before = _paths()
    with (csrc_copy / "flash_fwd.cu").open("a") as f:
        f.write("\n// edited\n")
    after = _paths()
    assert [n for n in before if before[n] != after[n]] == ["flash_fwd"]


def test_bf16_views_must_be_16_byte_aligned():
    base = torch.zeros(2 * 64 * 4 * 64 + 8, dtype=torch.bfloat16)
    aligned = base[:-8].view(2, 64, 4, 64)
    fa._check_last_dim(q=aligned)
    one = base[:64 * 4 * 64].as_strided((1, 64, 4, 64), (3, 256, 64, 1))
    fa._check_last_dim(q=one)  # a batch of one: its (odd) stride is never used
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._check_last_dim(q=base[1:-7].view(2, 64, 4, 64))  # base off by 2 bytes
    rows = torch.zeros(2, 64, 4, 68, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._check_last_dim(k=rows[..., :64])  # head stride 68 elements: 136 bytes
    fa._check_last_dim(v=rows.float()[..., :64])  # float32 takes no cp.async path


@pytest.fixture(scope="module")
def chip_smoke():
    import sys

    sys.path.insert(0, str(_build.CSRC.parents[1]))
    import chip_smoke

    return chip_smoke


def test_chip_smoke_reads_registers_and_spills_from_the_ptxas_log(chip_smoke):
    log = """ptxas info    : Compiling entry function '_Z4kernPf' for 'sm_90a'
ptxas info    : Function properties for _Z4kernPf
    8 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Function properties for _Z5otherv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers
"""
    rows = chip_smoke.ptxas_report(log)
    assert [(r["registers"], r["spill_stores"], r["spill_loads"]) for r in rows] == [
        (255, 12, 8), (30, 0, 0)]
    assert [r["kernel"] for r in rows] in (["_Z4kernPf", "_Z5otherv"],
                                           ["kern", "other"])


def test_tensor_core_check_passes_hgmma_for_a_wgmma_design(chip_smoke):
    sass = {"flash_fwd": {"HMMA": 224, "HGMMA": 0}, "flash_bwd": {"HMMA": 1568, "HGMMA": 36}}
    chip_smoke.check_tensor_cores(sass, chip_smoke.TC_DESIGNS)
    chip_smoke.check_tensor_cores({"flash_bwd": {"HMMA": 0, "HGMMA": 36}},
                                  {"flash_bwd": ("wgmma",)})


def test_tensor_core_check_fails_an_hmma_only_library_said_to_use_wgmma(chip_smoke):
    assert "wgmma" in chip_smoke.TC_DESIGNS["flash_bwd"]
    sass = {"flash_fwd": {"HMMA": 224, "HGMMA": 0}, "flash_bwd": {"HMMA": 1568, "HGMMA": 0}}
    with pytest.raises(AssertionError, match="flash_bwd: its wgmma design compiled to no HGMMA"):
        chip_smoke.check_tensor_cores(sass, chip_smoke.TC_DESIGNS)


@pytest.mark.parametrize("wrt", ["q", "kv"])
def test_sdpa_yardstick_computes_the_kernels_function(chip_smoke, wrt):
    """The yardstick timed beside K6b (wrt q) and K6a (wrt k, v) returns
    what those kernels compute: the plain backward's dQ, or its dK and dV."""
    import numpy as np

    rng = np.random.default_rng(11)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(2, 24, 3, 16)).astype(np.float32))
                  for _ in range(4))
    out, lse = fa.flash_attention_plain(q, k, v, causal=True)
    delta = (g * out).sum(-1)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, g, lse, delta, causal=True)
    got = chip_smoke.sdpa_grad(q, k, v, g, wrt)()
    want = (dq,) if wrt == "q" else (dk, dv)
    assert len(got) == len(want)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        torch.testing.assert_close(a, w, atol=1e-5, rtol=0)


def test_non_causal_sdpa_yardstick_computes_k4s_function(chip_smoke):
    """The yardstick timed beside K4 at the ViT's shape (non-causal, with
    respect to q, k and v) returns the plain non-causal backward."""
    import numpy as np

    rng = np.random.default_rng(12)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(2, 49, 3, 16)).astype(np.float32))
                  for _ in range(4))
    out, lse = fa.flash_attention_plain(q, k, v)
    want = fa.flash_attention_bwd_plain(q, k, v, g, lse, (g * out).sum(-1))
    got = chip_smoke.sdpa_grad(q, k, v, g, "qkv", causal=False)()
    assert len(got) == 3
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-5, rtol=0)


def _causal_dq_rows(n=32768, d=64):
    """Rows shaped like a long causal dQ: row i's scale falls as
    1/sqrt(i + 1), and row 0 is zero."""
    import numpy as np

    rows = np.random.default_rng(3).normal(size=(n, d)) / np.sqrt(np.arange(1, n + 1))[:, None]
    rows[0] = 0.0
    return torch.from_numpy(rows.astype(np.float32))


def test_row_error_catches_a_wrong_late_quarter_the_largest_magnitude_misses(chip_smoke):
    """A dQ whose last quarter is zero passes the check against the largest
    magnitude (early rows dominate it) but not the row-by-row one."""
    ref = _causal_dq_rows()
    got = ref.clone()
    got[3 * len(got) // 4:] = 0.0
    tol = chip_smoke.BWD_TOL["torch.bfloat16"]
    assert (got - ref).abs().max() / ref.abs().max() <= tol
    assert chip_smoke.row_rel_err(got, ref) >= 0.99
    assert chip_smoke.row_rel_err(got, ref) > chip_smoke.ROW_TOL["torch.bfloat16"]


def test_row_error_passes_bf16_rounding_and_a_zero_row(chip_smoke):
    """Rounding each element to bf16 stays well inside the row tolerance,
    and a zero reference row (causal row 0) is measured against the floor
    instead of dividing by zero."""
    ref = _causal_dq_rows()
    got = ref.to(torch.bfloat16)
    got[0] = 1e-6
    err = chip_smoke.row_rel_err(got, ref)
    assert err < 4e-3
    assert err < chip_smoke.ROW_TOL["torch.bfloat16"]


def _int8_lm(dtype, heads_kv=2):
    """A seeded 2-block causal LM with an int8 KV cache and GQA (4 query
    heads on ``heads_kv``), on the CPU."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model

    gen = torch.Generator().manual_seed(0)
    return get_model("causal_lm", num_classes=64, dim=64, depth=2, heads=4,
                     heads_kv=heads_kv, kv_cache_dtype="int8", dtype=dtype,
                     generator=gen, device="cpu")


def test_int8_attention_gate_holds_the_port_and_fails_the_planted_trap(chip_smoke):
    """(e)'s attention gate: the port's int8-cache attention matches the
    float64 reference in all but a sliver of its bf16 outputs, and the
    planted trap (probabilities rounded to bf16 before the PV product)
    fails the limit; the logit drift against the native cache cannot tell
    the two apart."""
    import importlib

    from distributed_tensorflow_ibm_mnist_tpu_torch.core.generate import init_cache

    kv8 = _int8_lm(torch.bfloat16)
    native = kv8.clone(kv_cache_dtype="native")
    tr = importlib.import_module(type(kv8.blocks[0]).__module__)
    x = torch.randint(1, 63, (2, 16), generator=torch.Generator().manual_seed(1))

    def drift():
        return chip_smoke.teacher_forced_drift(torch, native, kv8, init_cache, x, 8)

    clean = chip_smoke.int8_attention_mismatch(torch, tr, drift)
    trap = chip_smoke.int8_attention_mismatch(
        torch, tr, drift, chip_smoke.fault_p_bf16(torch, tr._attend_cached))
    assert clean <= chip_smoke.INT8_ATTN_MISMATCH / 10
    assert trap > 10 * chip_smoke.INT8_ATTN_MISMATCH
    assert tr._attend_cached.__name__ == "_attend_cached"  # restored


def test_planted_paged_v_scale_fault_breaks_paged_equals_dense(chip_smoke):
    """(e)'s paged == dense gate on a float32 model: it holds for the port
    and fails when the paged insert keeps stale ``pages_v_scale``."""
    import numpy as np

    from distributed_tensorflow_ibm_mnist_tpu_torch.serving import InferenceEngine
    from distributed_tensorflow_ibm_mnist_tpu_torch.serving import engine as eng_mod

    model = _int8_lm(torch.float32)
    prompts = [np.random.default_rng(i).integers(1, 63, 12).tolist() for i in range(4)]

    def serve(**kw):
        eng = InferenceEngine(model, slots=2, max_len=32, buckets=(16,), device="cpu",
                              quant="int8", **kw)
        reqs = [eng.submit(p, max_new=6) for p in prompts]
        eng.run()
        return [r.generated for r in reqs]

    dense = serve()
    assert serve(kv_page_size=4) == dense
    real = eng_mod.make_paged_insert
    eng_mod.make_paged_insert = chip_smoke.fault_paged_v_scale(real)
    try:
        faulty = serve(kv_page_size=4)
    finally:
        eng_mod.make_paged_insert = real
    assert faulty != dense


def test_resume_gate_holds_the_port_and_fails_both_planted_faults(chip_smoke, tmp_path):
    """fault_tolerant_training (a) on the CPU at toy size: the resumed run
    lands on the uninterrupted one within the run-to-run floor (0 here),
    and a resume without Adam's moments or with the data order restarted
    at epoch 0 does not."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
    from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig

    cfg = RunConfig(model="mlp", model_kwargs={"hidden": (32,), "dtype": torch.float32},
                    synthetic=True, n_train=256, n_test=64, batch_size=64, quiet=True,
                    schedule="cosine", epochs=chip_smoke.FT_EPOCHS, checkpoint_every=1)
    rec = chip_smoke.ft_resume_check(Trainer, cfg, tmp_path, "cpu")
    assert rec["floor"] == 0.0 and rec["passed"] and rec["diff"] == 0.0
    assert rec["final_step"] == chip_smoke.FT_EPOCHS * 4 and rec["first_step"] == 4
    assert set(rec["faults"]) == set(chip_smoke.FT_FAULTS)
    assert all(f["fails_gate"] and f["diff"] > 0 for f in rec["faults"].values())
    assert [t["step"] for t in rec["save_timings"]] == [4, 8, 12, 12]
