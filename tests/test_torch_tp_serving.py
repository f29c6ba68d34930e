"""The port's tensor-parallel serving (``InferenceEngine(tp=N)``: a leader
rank and N - 1 follower ranks over ``parallel/tensor_parallel.py``'s
``serving_mesh``, int8 weights cut as JAX shards them, the router over
disjoint tp groups) against the JAX package's engine, on the CPU.

The ranks are gloo processes (``tests/torch_tp_serving_ranks.py``, one spawn
of 2 and one of 4 for the module); the JAX references are JAX's own toy
(``tests/test_tp_serving.py:46-48``: vocab 16, dim 64, depth 2, 4 heads,
float32, max_len 32) and prompts, the weights carried across by
``convert.py``, each reference engine built once for the module.

* PARITY: JAX's eight ``CASES`` (dense and paged, native and int8 KV,
  decode_ahead 1 and 8, plain and n-gram speculation) at tp 2 and 4 are
  token-identical to JAX's tp=1 engine's stream for their KV dtype.  JAX's
  own ``test_tp_parity`` pins its tp=1 == tp=N, so this is equivalent to
  holding the port's tp=N against JAX's tp=N; one case (tp=2, dense,
  native) is also held against JAX's own tp=2 engine on the
  eight-virtual-device platform, tokens and per-chip bytes.
* MEMORY: every rank's KV and weight bytes equal JAX's ``per_chip_bytes``
  figures at tp 2 and 4, dense and paged (and int8 weights), and the stats
  carry them into the rollup as JAX's ``ServingStats.merge`` does.
* OPERATIONS: no build on any rank after ``prewarm``; ``swap_params`` with
  a whole host ``state_dict`` (seed 3) serves JAX's tp=1 stream for those
  weights, re-quantized under int8; chaos counts at ``serving-admit`` and
  ``serving-step`` are equal at tp 1, 2 and 4; a router over two tp=2
  groups whose followers are disjoint survives a transient
  ``serving-step`` fault token-identically with exactly one failover,
  full-precision and int8.
* RANKS: sampled streams are the same on every rank (every rank picks
  from the same logits with the same keys) and equal the tp=1 stream; a
  planted follower that replays each window with the previous window's
  tokens moves the streams; a follower that raises fails the leader's
  run within the model group's timeout, never hangs it, and under the
  router fails its replica over, after which the replica's failed group
  refuses a restart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_serving_ranks as ranks
from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.models.quant import quantize_params_int8
from distributed_tensorflow_ibm_mnist_tpu.parallel import tensor_parallel as jtp
from distributed_tensorflow_ibm_mnist_tpu.serving import FIFOScheduler as JaxScheduler
from distributed_tensorflow_ibm_mnist_tpu.serving import InferenceEngine as JaxEngine
from distributed_tensorflow_ibm_mnist_tpu.serving import ServingStats as JaxStats
from distributed_tensorflow_ibm_mnist_tpu.utils.chaos import FaultInjector as JaxInjector
from distributed_tensorflow_ibm_mnist_tpu.utils.chaos import FaultPlan as JaxPlan
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import causal_lm_state_dict, flax_layout
from distributed_tensorflow_ibm_mnist_tpu_torch.launch import torchrun
from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import tensor_parallel as tp
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import (
    FIFOScheduler,
    InferenceEngine,
    SamplingParams,
    ServingStats,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.chaos import FaultInjector, FaultPlan

torch.set_num_threads(1)

KW = dict(num_classes=16, dim=64, depth=2, heads=4)  # JAX's toy, in float32
MAX_LEN = ranks.MAX_LEN
PROMPTS = [[1, 2, 3, 1, 2, 3, 1, 2], [4, 5, 4, 5, 4, 5], [6, 7, 8, 9], [2, 4, 2, 4, 2, 4]]
CASES = [  # JAX's (tp, kv_dtype, paged, decode_ahead, speculative)
    (2, "native", False, 1, False),
    (2, "native", True, 1, False),
    (2, "int8", False, 8, False),
    (2, "native", True, 8, True),
    (4, "native", False, 8, False),
    (4, "int8", True, 1, False),
    (4, "native", False, 1, True),
    (4, "native", True, 8, False),
]
CASE_IDS = [f"tp{t}-{d}-{'paged' if p else 'dense'}-k{k}-{'spec' if s else 'plain'}"
            for t, d, p, k, s in CASES]
SAMPLED = [dict(temperature=0.8, top_k=8, seed=i) for i in range(len(PROMPTS))]
# a shared 8-token head (one page of 8): each later prompt's radix match
SHARED = [[1, 2, 3, 4, 5, 6, 7, 8, 9 + i, 10, 11] for i in range(4)]
FAULT_TIMEOUT_S = 3.0  # the model group's timeout of the raising-follower job


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_model(seed=0, **over):
    model = jax_get_model("causal_lm", **{**KW, "dtype": jnp.float32, **over})
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return model, params


def _jax_engine(model, params, tp=1, **ekw):
    return JaxEngine(model, params, slots=2, max_len=MAX_LEN, tp=tp,
                     scheduler=JaxScheduler(max_len=MAX_LEN, buckets=(16,),
                                            max_queue=len(PROMPTS)), **ekw)


def _jax_serve(model, params, tp=1, prompts=PROMPTS, **ekw):
    eng = _jax_engine(model, params, tp=tp, **ekw)
    reqs = [eng.submit(p, max_new=6) for p in prompts]
    eng.run()
    eng.close()
    return [list(r.generated) for r in reqs]


def _state(params) -> dict:
    """JAX params -> the port's state_dict as numpy (what a rank loads)."""
    return {k: v.numpy() for k, v in causal_lm_state_dict(_np(params), KW).items()}


def _port_engine(tm, state=None, **ekw):
    return InferenceEngine(
        tm, None if state is None else {k: torch.from_numpy(v) for k, v in state.items()},
        slots=2, max_len=MAX_LEN, device="cpu",
        scheduler=FIFOScheduler(max_len=MAX_LEN, buckets=(16,), max_queue=len(PROMPTS)),
        **ekw)


@pytest.fixture(scope="module")
def jax_refs(eight_devices):
    """JAX's streams and byte counts, each engine built once."""
    native, int8 = _jax_model(), _jax_model(kv_cache_dtype="int8")
    seed3 = _jax_model(seed=3)
    out = {"native": _jax_serve(*native), "int8": _jax_serve(*int8),
           "native_seed3": _jax_serve(*seed3), "quant": _jax_serve(*native, quant="int8"),
           "quant_seed3": _jax_serve(*seed3, quant="int8"),
           "shared": _jax_serve(*native, prompts=SHARED),
           "params": native[1], "params3": seed3[1]}
    inj = JaxInjector(JaxPlan(faults=()))
    _jax_serve(*native, chaos=inj)
    out["chaos"] = (inj.events("serving-admit"), inj.events("serving-step"))
    eng = _jax_engine(*native, tp=2)  # JAX's own tp=2 engine, the case (2, dense, native)
    reqs = [eng.submit(p, max_new=6) for p in PROMPTS]
    eng.run()
    out["tp2_engine"] = {"streams": [list(r.generated) for r in reqs],
                         "kv": eng.kv_bytes_per_chip(), "weights": eng.weight_bytes_per_chip()}
    eng.close()
    out["bytes"] = {}
    for n in (1, 2, 4):
        for layout, ekw in (("dense", {}), ("paged", {"kv_page_size": 8}),
                            ("quant", {"quant": "int8"})):
            eng = _jax_engine(*native, tp=n, **ekw)
            out["bytes"][n, layout] = (eng.kv_bytes_per_chip(), eng.weight_bytes_per_chip())
            eng.close()
    return out


def _case_job(case, state):
    t, kvd, paged, k, spec = case
    ekw = {"decode_ahead": k}
    if paged:
        ekw["kv_page_size"] = 8
    if spec:
        ekw.update(speculative="ngram", draft_len=3)
    kw = dict(KW, kv_cache_dtype="int8") if kvd == "int8" else KW
    return {"kind": "serve", "ranks": list(range(t)), "model_kw": kw, "state": state,
            "engine": ekw, "prompts": PROMPTS}


@pytest.fixture(scope="module")
def port(jax_refs, tmp_path_factory):
    """Both worlds' ranks, every job of a world in one spawn."""
    tmp = tmp_path_factory.mktemp("tp_serving")
    state, state3 = _state(jax_refs["params"]), _state(jax_refs["params3"])
    base = {"kind": "serve", "model_kw": KW, "state": state, "prompts": PROMPTS}
    jobs = {2: {}, 4: {}}
    for i, case in enumerate(CASES):
        jobs[case[0]][f"case{i}"] = _case_job(case, state)
    jobs[2]["case0"].update(prewarm=True, chaos=True)  # tp=2, dense, native, k=1
    jobs[2]["swap"] = dict(base, ranks=[0, 1], swap=state3)
    jobs[2]["sampled"] = dict(base, ranks=[0, 1], sampling=SAMPLED, log=True)
    jobs[2]["planted"] = dict(base, ranks=[0, 1], fault="stale_tokens")
    jobs[2]["chunked"] = dict(base, ranks=[0, 1], engine={"kv_page_size": 8,
                                                          "prefill_chunk": 8})
    jobs[2]["radix"] = dict(base, ranks=[0, 1], prompts=SHARED, engine={"kv_page_size": 8})
    jobs[2]["prefix"] = dict(base, ranks=[0, 1], prompts=PROMPTS + PROMPTS,
                             engine={"prefix_cache_bytes": 1 << 20})
    jobs[4]["chaos"] = dict(base, ranks=[0, 1, 2, 3], chaos=True)
    for n in (2, 4):
        jobs[n]["quant"] = dict(base, ranks=list(range(n)), engine={"quant": "int8"},
                                scales=True, swap=state3)
    groups = tp.tp_device_groups(2, 2, devices=range(4), leader=0)
    jobs[4]["router"] = {"kind": "router", "groups": groups, "model_kw": KW, "state": state,
                         "prompts": PROMPTS}
    jobs[4]["router_quant"] = dict(jobs[4]["router"], engine={"quant": "int8"})
    # last: its own meshes, the first of which its raising follower leaves failed
    jobs[4]["router_fault"] = dict(jobs[4]["router"], fault="raise", timeout_s=FAULT_TIMEOUT_S)
    jobs[2]["from_trainer"] = {"kind": "from_trainer", "prompt": [1, 2, 3], "config": dict(
        model="causal_lm", dataset="retrieval", dataset_kwargs={"vocab": 16, "seq_len": 16},
        model_kwargs={"dim": 32, "depth": 2, "heads": 4, "dtype": torch.float32},
        n_train=16, n_test=16, batch_size=16, eval_batch_size=16, epochs=1, quiet=True,
        seed=4, target_accuracy=None, tp=2)}
    # last: its own mesh, whose model group the raising follower leaves stuck
    jobs[2]["fault"] = dict(base, ranks=[0, 1], fault="raise", timeout_s=FAULT_TIMEOUT_S)
    out = {w: torchrun.spawn(ranks.run, w, "gloo", "cpu", tmp / f"store{w}",
                             args=(w, jobs[w]), timeout=420) for w in (2, 4)}
    # the port's own tp=1 runs: sampled streams, chaos counts
    tm = get_model("causal_lm", device="cpu", dtype=torch.float32, **KW)
    eng = _port_engine(tm, state)
    reqs = [eng.submit(p, max_new=6, sampling=SamplingParams(**s))
            for p, s in zip(PROMPTS, SAMPLED)]
    eng.run()
    sampled1 = [list(r.generated) for r in reqs]
    inj = FaultInjector(FaultPlan(faults=()))
    eng = _port_engine(tm, state, chaos=inj)
    for p in PROMPTS:
        eng.submit(p, max_new=6)
    eng.run()
    prefix = InferenceEngine(tm, slots=2, max_len=MAX_LEN, device="cpu",
                             prefix_cache_bytes=1 << 20, scheduler=FIFOScheduler(
                                 max_len=MAX_LEN, buckets=(16,), max_queue=2 * len(PROMPTS)))
    for p in PROMPTS + PROMPTS:
        prefix.submit(p, max_new=6)
    prefix.run()
    return {"ranks": out, "groups": groups, "sampled_tp1": sampled1,
            "chaos_tp1": (inj.events("serving-admit"), inj.events("serving-step")),
            "prefix_tp1": (prefix._prefix.bytes, prefix.stats.summary()["prefix_hits"])}


def _leader(port, world, name):
    return port["ranks"][world][0][name]


def _followers(port, world, name):
    return [r[name] for r in port["ranks"][world][1:] if r[name] is not None]


# ---------------------------------------------------------------- parity


def test_ranks_import_no_jax(port):
    assert all(not r["forbidden"] for w in (2, 4) for r in port["ranks"][w])


@pytest.mark.parametrize("i", range(len(CASES)), ids=CASE_IDS)
def test_tp_parity(port, jax_refs, i):
    """JAX's curated composition slice at tp 2 and 4: the port's stream
    equals JAX's tp=1 engine's for the case's KV dtype (JAX's own
    ``test_tp_parity`` pins its tp=1 == tp=N, so this holds the port's tp=N
    against JAX's tp=N), and every follower followed the whole run."""
    t, kvd = CASES[i][:2]
    assert _leader(port, t, f"case{i}")["streams"] == jax_refs[kvd]
    for f in _followers(port, t, f"case{i}"):
        assert f["follow"]["ops"]["window" if not CASES[i][4] else "verify"] > 0


def test_tp2_equals_jaxs_own_tp2_engine(port, jax_refs):
    """The case (2, dense, native, k=1, plain) against JAX's own tp=2
    engine on the eight-virtual-device platform: the tokens and the
    per-chip KV and weight bytes."""
    want = jax_refs["tp2_engine"]
    assert _leader(port, 2, "case0")["streams"] == want["streams"]
    for r in port["ranks"][2]:
        assert (r["case0"]["kv_bytes"], r["case0"]["weight_bytes"]) == (want["kv"],
                                                                         want["weights"])


# ---------------------------------------------------------------- memory


@pytest.mark.parametrize("layout, cases", [("dense", (0, 4)), ("paged", (1, 7))])
def test_per_rank_bytes_equal_jaxs_per_chip_bytes(port, jax_refs, layout, cases):
    """Every rank's KV and weight bytes at tp 2 and 4 are JAX's
    ``per_chip_bytes`` figures (1/tp of the slabs and of the split leaves,
    the cursors, block tables, norms and row biases whole), within JAX's
    own 0.9-1.1 x tp of the tp=1 figures; the leader's stats carry them."""
    one = jax_refs["bytes"][1, layout]
    for i in cases:
        n = CASES[i][0]
        want = jax_refs["bytes"][n, layout]
        for r in port["ranks"][n]:
            assert (r[f"case{i}"]["kv_bytes"], r[f"case{i}"]["weight_bytes"]) == want
        assert all(0.9 * n <= a / b <= 1.1 * n for a, b in zip(one, want))
        s = _leader(port, n, f"case{i}")["summary"]
        assert (s["tp"], s["kv_bytes_per_chip"], s["weight_bytes_per_chip"], s["quant"]) == (
            n, *want, "none")


def test_stats_memory_merges_into_rollup_as_jaxs():
    """``ServingStats.merge`` of tp-stamped records equals JAX's: the
    homogeneous tp, the worst rank's bytes, the cluster sums; never NaN;
    mixed tp -> None."""
    def stamped(cls, stamps):
        out = []
        for s in stamps:
            st = cls(2)
            if s is not None:
                st.memory(tp=s[0], kv_bytes_per_chip=s[1], weight_bytes_per_chip=s[2])
            out.append(st)
        return out

    keys = ("tp", "kv_bytes_per_chip", "weight_bytes_per_chip", "kv_bytes_cluster",
            "weight_bytes_cluster")
    for stamps in ([(2, 100, 1000), (2, 80, 1000)], [None], [(2, 100, 1000), (4, 80, 1000)]):
        got = ServingStats.merge(stamped(ServingStats, stamps))
        want = JaxStats.merge(stamped(JaxStats, stamps))
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert ServingStats.merge(stamped(ServingStats, [(2, 100, 1000), (2, 80, 1000)]))[
        "kv_bytes_cluster"] == (100 + 80) * 2


# ---------------------------------------------------------------- operations


def test_prewarm_under_tp_then_no_build_on_any_rank(port, jax_refs):
    lead = _leader(port, 2, "case0")
    assert lead["builds_after_prewarm"] == 0 and lead["streams"] == jax_refs["native"]
    for f in _followers(port, 2, "case0"):
        assert f["follow"]["compile_since"]["prewarm"]["n_compiled_programs"] == 0
        assert f["follow"]["ops"]["mark"] == 1


def test_swap_params_reslices_a_whole_host_state_dict(port, jax_refs):
    """``swap_params`` at tp=2 with a whole host state_dict from seed 3:
    the leader's stream before is seed 0's, after it JAX's tp=1 stream for
    seed 3 (each rank kept its block; the follower got the swap from its
    leader)."""
    lead = _leader(port, 2, "swap")
    assert lead["streams"] == jax_refs["native"]
    assert lead["swapped"] == jax_refs["native_seed3"]
    assert all(f["follow"]["ops"]["swap"] == 1 for f in _followers(port, 2, "swap"))


def test_chunked_radix_and_prefix_hits_compose_at_tp2(port, jax_refs):
    """Chunked prefill (chunks of 8 through the extend on every rank),
    radix hits (the shared head's page extended over) and prefix-cache hits
    at tp=2 give JAX's tp=1 streams; the prefix cache counts its rows whole
    (as one card holds them), so it holds the bytes and hits of tp=1."""
    chunked = _leader(port, 2, "chunked")
    assert chunked["streams"] == jax_refs["native"]
    assert chunked["summary"]["n_prefill_chunks"] >= len(PROMPTS)
    radix = _leader(port, 2, "radix")
    assert radix["streams"] == jax_refs["shared"]
    assert radix["summary"]["radix_hits"] == len(SHARED) - 1
    prefix = _leader(port, 2, "prefix")
    assert prefix["streams"] == jax_refs["native"] + jax_refs["native"]
    assert (prefix["prefix_bytes"], prefix["summary"]["prefix_hits"]) == port["prefix_tp1"]
    assert port["prefix_tp1"][1] == len(PROMPTS)


def test_chaos_event_counts_tp_invariant(port, jax_refs):
    counts = {1: port["chaos_tp1"], 2: _leader(port, 2, "case0")["chaos"],
              4: _leader(port, 4, "chaos")["chaos"]}
    assert counts[1] == counts[2] == counts[4] == jax_refs["chaos"], counts
    assert counts[1][0] >= len(PROMPTS) and counts[1][1] > 0


@pytest.mark.parametrize("name, ref", [("router", "native"), ("router_quant", "quant")])
def test_router_failover_over_disjoint_tp_groups(port, jax_refs, name, ref):
    """Two replicas over tp=2 groups whose followers are disjoint (the
    router's process holds each leader); a transient ``serving-step`` fault
    at event 1 kills one mid-wave; the wave finishes token-identically with
    exactly one failover, and the rollup carries tp and the cluster bytes."""
    groups = port["groups"]
    assert groups == [[0, 1], [0, 2]] and not set(groups[0][1:]) & set(groups[1][1:])
    lead = _leader(port, 4, name)
    assert lead["streams"] == jax_refs[ref]
    assert lead["statuses"] == ["done"] * len(PROMPTS) and lead["failovers"] == 1
    assert lead["summary"]["tp"] == 2 and lead["summary"]["kv_bytes_cluster"] is not None
    assert lead["summary"]["quant"] == ("int8" if ref == "quant" else "none")
    followed = [port["ranks"][4][r][name] for r in (1, 2)]
    assert all(len(f["follow"]) == 1 for f in followed)  # one engine each, no respawn
    assert port["ranks"][4][3][name] is None


def test_from_trainer_serves_a_tp_run_on_its_model_group(port):
    """``InferenceEngine.from_trainer`` on a tp=2 run serves at tp=2 on the
    run's model group (2 of the 4 heads a rank) and gives the run's own
    ``generate`` tokens (its whole weights on one device)."""
    lead = _leader(port, 2, "from_trainer")
    assert lead["stream"] == lead["want"] and lead["tp"] == 2
    for r in port["ranks"][2]:
        assert r["from_trainer"]["heads_kv_a_rank"] == 2
    assert _followers(port, 2, "from_trainer")[0]["follow"]["ops"]["window"] > 0


# ---------------------------------------------------------------- int8 weights


def _head_major_block(whole: np.ndarray, n: int, r: int, parts: int = 3) -> np.ndarray:
    order = tp.head_major_order(whole.shape[0], parts, n).numpy()
    return np.split(whole[order], n)[r]


@pytest.mark.parametrize("n", [2, 4])
def test_quant_tp_parity_and_scale_layout(port, jax_refs, n):
    """int8 weights at tp=N: the stream is JAX's tp=1 int8 stream; each
    rank holds its head-major block of the int8 ``qkv`` rows with their
    scales (JAX's spec: the column scale split with the output features)
    and its block of ``proj``'s columns with the whole scale (JAX's spec:
    the row scale replicated), the int8 values and scales bit-equal to
    JAX's ``quantize_params_int8``."""
    q = _np(quantize_params_int8(jax_refs["params"]))["block_0"]
    specs = jtp.make_param_specs(quantize_params_int8(jax_refs["params"]),
                                 jtp.megatron_rule(n, axis="tp"))
    assert specs["block_0"]["qkv"]["scale"] == jtp.P("tp")
    assert specs["block_0"]["proj"]["scale"] == jtp.P()
    assert _leader(port, n, "quant")["streams"] == jax_refs["quant"]
    for r, rec in enumerate(port["ranks"][n]):
        s = rec["quant"]["scales"]
        np.testing.assert_array_equal(s["blocks.0.qkv.weight"],
                                      _head_major_block(q["qkv"]["kernel"].T, n, r))
        np.testing.assert_array_equal(s["blocks.0.qkv.scale"],
                                      _head_major_block(q["qkv"]["scale"], n, r))
        np.testing.assert_array_equal(s["blocks.0.proj.weight"],
                                      np.split(q["proj"]["kernel"].T, n, axis=1)[r])
        np.testing.assert_array_equal(s["blocks.0.proj.scale"], q["proj"]["scale"])


def test_quant_specs_follow_jaxs_rule_on_the_quantized_tree():
    """``model_param_specs`` of the int8 model (its kernels and scale
    buffers read off ``flax_layout``) is JAX's ``megatron_rule`` over JAX's
    quantized tree, leaf by leaf, in the port's layout."""
    jm, params = _jax_model()
    qtree = quantize_params_int8(params)
    tm = get_model("causal_lm", device="cpu", dtype=torch.float32, quant="int8", **KW)
    for n in (2, 4):
        jspecs = jtp.make_param_specs(qtree, jtp.megatron_rule(n, axis="tp"))
        got = tp.model_param_specs(tm, tp.megatron_rule(n, axis="tp"))
        layout = flax_layout(tm)
        assert set(got) == set(tm.state_dict())
        for name, (path, how, _) in layout.items():
            node = jspecs
            for key in path:
                node = node[key]
            assert got[name] == tp._port_spec(tp.P(*node), how), name


@pytest.mark.parametrize("n", [2, 4])
def test_quant_per_chip_weight_bytes(port, jax_refs, n):
    """int8 weight bytes a rank are JAX's quant engine's per-chip figure."""
    want = jax_refs["bytes"][n, "quant"][1]
    assert all(r["quant"]["weight_bytes"] == want for r in port["ranks"][n])
    assert _leader(port, n, "quant")["summary"]["quant"] == "int8"


@pytest.mark.parametrize("n", [2, 4])
def test_quant_swap_requantizes_and_reslices(port, jax_refs, n):
    """swap_params at tp=N with a full-precision host state_dict: every
    rank quantizes it whole and keeps its block; the stream is JAX's tp=1
    int8 stream on those weights."""
    assert _leader(port, n, "quant")["swapped"] == jax_refs["quant_seed3"]
    q3 = _np(quantize_params_int8(jax_refs["params3"]))["block_0"]
    np.testing.assert_array_equal(
        _leader(port, n, "quant")["swapped_scales"]["blocks.0.qkv.scale"],
        _head_major_block(q3["qkv"]["scale"], n, 0))


# ---------------------------------------------------------------- the ranks


def test_sampled_streams_are_the_same_on_every_rank(port):
    """At temperature 0.8 every rank picks the same tokens, window by
    window (the head's all-reduce gives each rank the same logits, and the
    keys are the same), and the leader's streams equal the tp=1 engine's."""
    lead = _leader(port, 2, "sampled")
    assert lead["streams"] == port["sampled_tp1"]
    for f in _followers(port, 2, "sampled"):
        assert len(f["windows"]) == len(lead["windows"]) > 0
        for a, b in zip(f["windows"], lead["windows"]):
            np.testing.assert_array_equal(a, b)


def _differing(streams, want) -> int:
    return sum(x != y for a, b in zip(streams, want) for x, y in zip(a, b))


def test_a_follower_replaying_stale_tokens_moves_the_streams(port, jax_refs):
    """The planted fault this file must catch: a follower that feeds each
    window the previous window's input tokens (its K/V heads then hold the
    wrong tokens) moves the leader's streams; the sound run (case 0) moves
    none."""
    sound = _differing(_leader(port, 2, "case0")["streams"], jax_refs["native"])
    planted = _differing(_leader(port, 2, "planted")["streams"], jax_refs["native"])
    assert sound == 0 and planted > 0, (sound, planted)


def test_a_raising_follower_fails_the_leader_within_the_timeout(port):
    """A follower whose second window raises: the leader's run raises
    within the model group's timeout (never hangs) and fails its in-flight
    requests as engine faults; the follower's follow() re-raised."""
    lead = _leader(port, 2, "fault")
    assert lead["error"] and lead["error_s"] < FAULT_TIMEOUT_S + 10.0, lead
    assert any(s == ("failed", True) for s in lead["statuses"])
    assert all(s[0] in ("failed", "cancelled") and s[1] for s in lead["statuses"])
    assert "planted" in _followers(port, 2, "fault")[0]["raised"]


def test_a_follower_fault_under_the_router_fails_over_and_refuses_a_restart(port, jax_refs):
    """Replica 0's follower raises at its second window under the router:
    its leader's collective fails within the model group's timeout, the
    wave finishes token-identically on replica 1 with exactly one
    failover, the follower's ``follow_engines`` re-raised with its mesh
    marked failed, and ``Router.restart(0)`` refuses the failed group at
    once (no engine is built to wait out a timeout on it); replica 1's
    follower followed one engine and was released."""
    lead = _leader(port, 4, "router_fault")
    assert lead["streams"] == jax_refs["native"]
    assert lead["statuses"] == ["done"] * len(PROMPTS) and lead["failovers"] == 1
    assert "no engine is built on it again" in lead["restart"], lead["restart"]
    assert lead["states"] == ["failed", "healthy"]
    raised = port["ranks"][4][1]["router_fault"]
    assert "planted" in raised["raised"] and raised["mesh_failed"], raised
    assert len(port["ranks"][4][2]["router_fault"]["follow"]) == 1
    assert port["ranks"][4][3]["router_fault"] is None


# ---------------------------------------------------------------- refusals


def _error(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def test_tp_must_divide_heads_whole_with_jaxs_message():
    jm, params = _jax_model()
    gm, gparams = _jax_model(heads_kv=2)
    tm = get_model("causal_lm", device="cpu", dtype=torch.float32, **KW)
    tg = get_model("causal_lm", device="cpu", dtype=torch.float32, heads_kv=2, **KW)
    for (j, jp, t), n in (((jm, params, tm), 3), ((gm, gparams, tg), 4)):
        want = _error(lambda: _jax_engine(j, jp, tp=n))
        assert want is not None and "divide" in want
        assert _error(lambda: _port_engine(t, tp=n)) == want


def test_what_tp_serving_leaves_names_its_item():
    """cp and roles beside tp are ported (tests/test_torch_cp_serving.py):
    cp on the dense layout takes JAX's refusal, and a role engine at tp=2,
    like a cp mesh, asks for the launcher outside a spawned world; MoE
    blocks beside tp are served since item 7.7 (tests/test_torch_moe_mesh_serving.py),
    so they too ask for the launcher here."""
    jm, params = _jax_model()
    tm = get_model("causal_lm", device="cpu", dtype=torch.float32, **KW)
    want = _error(lambda: _jax_engine(jm, params, cp=2))
    assert want is not None and _error(lambda: _port_engine(tm, cp=2)) == want
    assert "launch.torchrun" in _error(lambda: _port_engine(tm, tp=2, kv_page_size=8,
                                                            role="prefill"))
    moe = get_model("causal_lm", device="cpu", dtype=torch.float32, moe_every=2, **KW)
    assert "launch.torchrun" in _error(lambda: _port_engine(moe, tp=2))
    # outside a spawned world a tp engine asks for the launcher, as the Trainer's tp does
    assert "launch.torchrun" in _error(lambda: _port_engine(tm, tp=2))
    with pytest.raises(ValueError, match="launch.torchrun"):
        tp.serving_mesh(2, cp=2)


# ---------------------------------------------------------------- the helpers


def test_kv_cache_rule_matches_jaxs():
    """The head-axis split of dense and paged slabs and of their int8
    scales, whole cursors and block tables, and the indivisible degrade,
    spec for spec against JAX's rule; with ``cp = 2`` also the split of a
    pool's pages and of a dense slab's positions."""
    leaves = {"k": (2, 32, 4, 16), "v": (2, 32, 4, 16), "k_scale": (2, 32, 4),
              "pages_k": (9, 8, 4, 16), "pages_v_scale": (9, 8, 4), "index": (2,),
              "block_table": (2, 4), "k_odd": (2, 32, 3, 16)}
    for n in (1, 2, 4):
        for name, shape in leaves.items():
            leaf = name.removesuffix("_odd")
            want = jtp.kv_cache_rule(n)((leaf,), jax.ShapeDtypeStruct(shape, jnp.float32))
            assert tp.kv_cache_rule(n)((leaf,), tp.Leaf(shape)) == tuple(want), (n, name)
            want = jtp.kv_cache_rule(n, cp=2)((leaf,), jax.ShapeDtypeStruct(shape, jnp.float32))
            assert tp.kv_cache_rule(n, cp=2)((leaf,), tp.Leaf(shape)) == tuple(want), (n, name)
    with pytest.raises(ValueError, match="n_shards"):
        tp.kv_cache_rule(0)


def test_tp_device_groups_match_jaxs_and_the_leader_layout():
    devs = list(range(8))
    for n_groups, n in ((2, 2), (2, 4), (4, 2), (1, 8)):
        assert tp.tp_device_groups(n_groups, n, devices=devs) == jtp.tp_device_groups(
            n_groups, n, devs)
    assert tp.tp_device_groups(2, 2, devices=range(4), leader=0) == [[0, 1], [0, 2]]
    assert tp.tp_device_groups(3, 2, devices=range(4), leader=0) == [[0, 1], [0, 2], [0, 3]]
    for kw in (dict(n_groups=3, tp=4), dict(n_groups=4, tp=2, leader=0)):
        with pytest.raises(ValueError, match="needs"):
            tp.tp_device_groups(devices=range(4), **kw)
    with pytest.raises(ValueError, match="needs"):
        jtp.tp_device_groups(3, 4, list(range(4)))


def test_per_chip_bytes_counts_what_a_rank_holds():
    tree = {"block_0": {"k": torch.zeros(2, 4, 2, 8), "index": torch.zeros(2, dtype=torch.int32)},
            "host": np.zeros(3, np.float64)}
    assert tp.per_chip_bytes(tree) == 2 * 4 * 2 * 8 * 4 + 2 * 4 + 3 * 8
    assert tp.per_chip_bytes(tree, device="cpu") == tp.per_chip_bytes(tree)
    assert tp.kv_whole_bytes({"block_0": {"k": torch.zeros(2, 4, 2, 8),
                                          "index": torch.zeros(2, dtype=torch.int32)}},
                             2) == 2 * 2 * 4 * 2 * 8 * 4 + 2 * 4
