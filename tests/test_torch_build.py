"""The port's kernel build and binding, checked without nvcc or a GPU.

* A library's name carries the hash of its source AND of every shared
  header ``csrc/*.cuh``: editing a header renames every library (so no
  stale build is reused), editing one source renames only its own.
* Every ``extern "C"`` entry in ``csrc/*.cu`` has a ctypes argument list
  in the port (``ARGTYPES`` of ``ops/flash_attention.py`` and
  ``ops/xent.py``) that matches its declaration parameter by parameter, so
  a C signature cannot change without its caller.
* The bf16 wrappers refuse a view whose base or strides are not 16-byte
  aligned (the kernels copy 16-byte chunks with cp.async).
"""

import ctypes
import re
import shutil

import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.ops import _build
from distributed_tensorflow_ibm_mnist_tpu_torch.ops import flash_attention as fa
from distributed_tensorflow_ibm_mnist_tpu_torch.ops import xent

ARGTYPES = {**fa.ARGTYPES, **xent.ARGTYPES}
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
    assert len(ARGTYPES) == 6


@pytest.mark.parametrize("name", sorted(ARGTYPES))
def test_ctypes_arguments_match_the_c_declaration(name):
    c_kinds = _c_entries()[name]
    py_kinds = [KIND[t] for t in ARGTYPES[name]]
    assert py_kinds == c_kinds, f"{name}: ctypes {py_kinds} != C {c_kinds}"


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
    assert set(before) == set(after) == {"flash_bwd", "flash_fwd", "xent"}
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


def test_chip_smoke_reads_registers_and_spills_from_the_ptxas_log():
    import sys

    sys.path.insert(0, str(_build.CSRC.parents[1]))
    import chip_smoke

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
