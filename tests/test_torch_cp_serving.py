"""The port's context-parallel serving (``InferenceEngine(cp=N)``: a ``(cp,
tp)`` ``parallel/tensor_parallel.serving_mesh``, the paged pool split over
its page axis, the ring prefill over the cp group, the decode merge) and
the disaggregated handoff across tp and cp, against the JAX package's
engine on the CPU.

The ranks are gloo processes (``tests/torch_cp_ranks.py``, one spawn of 2
and one of 4 for the module); the JAX references are JAX's own toy
(``tests/test_cp_serving.py:43-48``: vocab 16, dim 64, depth 2, 4 heads,
float32, max_len 32, page 8) and prompts, the weights carried across by
``convert.py``, each reference engine built once for the module.

* PARITY: JAX's five ``CASES`` (cp2 native, cp2 int8 KV, cp2 n-gram
  speculation, cp4, cp2 x tp2) are token-identical to JAX's cp=1 paged
  engine for their KV dtype on the same pool (JAX's own ``test_cp_parity``
  pins cp=N == cp=1). Cases 1-4 run on a pool that puts the second slot's
  pages on a later cp row (``SPREAD``; the pool hands out the lowest ids
  first, so at the default pool every live page sits on row 0); cp2
  native runs at the default pool, where it is also held against JAX's own
  cp=2 engine on the eight-virtual-device platform, tokens and per-chip
  bytes.
* MEMORY: every rank's KV bytes equal JAX's ``per_chip_bytes`` at cp 2 and
  4 and at cp2 x tp2, at a fixed ``kv_pages``; the default pool rounds up
  to a multiple of cp as JAX's does.
* OPERATIONS: no build on any rank after ``prewarm``, whose sites are
  cp-qualified; chaos counts at ``serving-admit`` and ``serving-step`` are
  equal at cp 1, 2 and 4; ``ring_hop`` spans carry JAX's ``comm_bytes``;
  radix hits and chunked prefill compose at cp=2 across both rows; JAX's
  refusals come with JAX's messages.
* PLANTED FAULTS: a decode merge that drops cp rank 1's partial, an insert
  that writes each page on the wrong cp row, and an int8 insert that writes
  only the scale pages there, each move the streams.
* HANDOFF: prefill replicas at tp=2 and cp=2 (and tp=1) hand off to decode
  replicas at tp=2 or tp=1 under the ``Router``, token-identical to the
  monolithic tp=1 stream; a packet assembled over a cp=2 or tp=2 mesh holds
  JAX's per-page trees at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cp_ranks as ranks
from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.parallel import tensor_parallel as jtp
from distributed_tensorflow_ibm_mnist_tpu.parallel.ring_attention import (
    vanilla_attention as jax_vanilla,
)
from distributed_tensorflow_ibm_mnist_tpu.serving import FIFOScheduler as JaxScheduler
from distributed_tensorflow_ibm_mnist_tpu.serving import InferenceEngine as JaxEngine
from distributed_tensorflow_ibm_mnist_tpu.serving import ServingStats as JaxStats
from distributed_tensorflow_ibm_mnist_tpu.utils.chaos import FaultInjector as JaxInjector
from distributed_tensorflow_ibm_mnist_tpu.utils.chaos import FaultPlan as JaxPlan
from distributed_tensorflow_ibm_mnist_tpu.utils.flops import ring_hop_bytes as jax_hop_bytes
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import causal_lm_state_dict
from distributed_tensorflow_ibm_mnist_tpu_torch.launch import torchrun
from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import tensor_parallel as tp
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.ring_attention import vanilla_attention
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import (
    FIFOScheduler,
    InferenceEngine,
    ServingStats,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.chaos import FaultInjector, FaultPlan
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.flops import ring_hop_bytes

torch.set_num_threads(1)

KW = dict(num_classes=16, dim=64, depth=2, heads=4)  # JAX's toy, in float32
MAX_LEN = ranks.MAX_LEN
PROMPTS = [[1, 2, 3, 1, 2, 3, 1, 2], [4, 5, 4, 5, 4, 5], [6, 7, 8, 9], [2, 4, 2, 4, 2, 4]]
CASES = [  # JAX's (cp, tp, kv_dtype, speculative)
    (2, 1, "native", False),
    (2, 1, "int8", False),
    (2, 1, "native", True),
    (4, 1, "native", False),
    (2, 2, "native", False),
]
CASE_IDS = [f"cp{c}-tp{t}-{d}-{'spec' if s else 'plain'}" for c, t, d, s in CASES]
# the pool (kv_pages) a cp puts the second slot on a later row with: 3 pages
# a row at cp=2 (slot 0 takes pages 1-2, slot 1 pages 3-4), 2 at cp=4
# (pages 1-2 and 3-4 span rows 0-2); None: the default pool
SPREAD = {2: 6, 4: 8}
CASE_POOLS = [None] + [SPREAD[c] for c, *_ in CASES[1:]]
RADIX_POOL = 8  # 4 a row: the shared head's page on row 0, its extension on row 1
# each planted fault: its KV dtype, and the sound job on the same pool
FAULTS = {"drop_partial": ("native", "spread"), "wrong_page": ("native", "spread"),
          "wrong_scale_page": ("int8", "case1")}
# a shared 8-token head (one page of 8): each later prompt's radix match
SHARED = [[1, 2, 3, 4, 5, 6, 7, 8, 9 + i, 10, 11] for i in range(4)]
PACKET_PROMPT = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]  # two pages of 8
MEMORY = {"cp2": (2, 1), "cp4": (4, 1), "cp2xtp2": (2, 2)}  # at kv_pages=16
HANDOFFS = {  # (world, groups, (tp, cp) of the prefill and the decode replica)
    "tp2_to_tp2": (4, [[0, 1], [0, 2]], [(2, 1), (2, 1)]),
    "tp2_to_tp1": (2, [[0, 1], [0]], [(2, 1), (1, 1)]),
    "cp2_to_cp1": (2, [[0, 1], [0]], [(1, 2), (1, 1)]),
    "tp1_to_tp2": (2, [[0], [0, 1]], [(1, 1), (2, 1)]),
}
ATOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_model(**over):
    model = jax_get_model("causal_lm", **{**KW, "dtype": jnp.float32, **over})
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return model, params


def _jax_engine(model, params, cp=1, tp=1, **ekw):
    ekw.setdefault("kv_page_size", 8)
    return JaxEngine(model, params, slots=2, max_len=MAX_LEN, cp=cp, tp=tp,
                     scheduler=JaxScheduler(max_len=MAX_LEN, buckets=(16,),
                                            max_queue=len(PROMPTS)), **ekw)


def _jax_serve(model, params, prompts=PROMPTS, **ekw):
    eng = _jax_engine(model, params, **ekw)
    reqs = [eng.submit(p, max_new=6) for p in prompts]
    eng.run()
    eng.close()
    return [list(r.generated) for r in reqs], eng


def _state(params, **kw) -> dict:
    return {k: v.numpy() for k, v in causal_lm_state_dict(_np(params), {**KW, **kw}).items()}


@pytest.fixture(scope="module")
def jax_refs(eight_devices):
    """JAX's streams, byte counts, chaos counts and packet, each engine built
    once."""
    native, int8 = _jax_model(), _jax_model(kv_cache_dtype="int8")
    out = {"native": _jax_serve(*native)[0],
           "shared": _jax_serve(*native, prompts=SHARED, kv_pages=RADIX_POOL)[0],
           "params": native[1], "params8": int8[1]}
    # (KV dtype, pool): the cp=1 streams each case and fault is held to
    models = {"native": native, "int8": int8}
    out["streams"] = {(kvd, pool): _jax_serve(*models[kvd], kv_pages=pool)[0]
                      for kvd, pool in {(CASES[i][2], CASE_POOLS[i])
                                        for i in range(1, len(CASES))}}
    out["streams"][("native", None)] = out["native"]
    inj = JaxInjector(JaxPlan(faults=()))
    _jax_serve(*native, chaos=inj)
    out["chaos"] = (inj.events("serving-admit"), inj.events("serving-step"))
    streams, eng = _jax_serve(*native, cp=2)  # JAX's own cp=2 engine, case 0
    out["cp2_engine"] = {"streams": streams, "kv": eng.kv_bytes_per_chip(),
                         "kv_pages": eng._kv_pages}
    out["kv_pages_cp4"] = _jax_engine(*native, cp=4)._kv_pages
    out["bytes"] = {}
    for name, (cp, n) in {"cp1": (1, 1), **MEMORY}.items():
        eng = _jax_engine(*native, cp=cp, tp=n, kv_pages=16)
        out["bytes"][name] = eng.kv_bytes_per_chip()
        eng.close()
    src = _jax_engine(*native, role="prefill")
    src.submit(PACKET_PROMPT, max_new=4)
    src.step()
    (packet,) = list(src._outbox)
    out["packet"] = {"payloads": [jax.tree.leaves(_np(t)) for t in packet.payloads],
                     "last_logits": np.asarray(packet.last_logits), "n_tok": packet.n_tok}
    return out


@pytest.fixture(scope="module")
def port(jax_refs, tmp_path_factory):
    """Both worlds' ranks, every job of a world in one spawn."""
    tmp = tmp_path_factory.mktemp("cp_serving")
    state, state8 = _state(jax_refs["params"]), _state(jax_refs["params8"],
                                                      kv_cache_dtype="int8")
    base = {"kind": "serve", "model_kw": KW, "state": state, "prompts": PROMPTS}
    jobs = {2: {}, 4: {}}
    for i, (cp, n, kvd, spec) in enumerate(CASES):
        job = dict(base, ranks=list(range(cp * n)), cp=cp, tp=n)
        if kvd == "int8":
            job.update(model_kw=dict(KW, kv_cache_dtype="int8"), state=state8)
        if spec:
            job["engine"] = {"speculative": "ngram", "draft_len": 3}
        if CASE_POOLS[i]:
            job["engine"] = dict(job.get("engine", {}), kv_pages=CASE_POOLS[i])
        jobs[cp * n][f"case{i}"] = job
    jobs[2]["case0"].update(prewarm=True, chaos=True, trace=True)
    jobs[4]["case3"].update(chaos=True)
    for name, (cp, n) in MEMORY.items():
        jobs[cp * n][name] = dict(base, ranks=list(range(cp * n)), cp=cp, tp=n, prompts=[],
                                  engine={"kv_pages": 16})
    jobs[4]["default_cp4"] = dict(base, ranks=[0, 1, 2, 3], cp=4, tp=1, prompts=[])
    two = dict(base, ranks=[0, 1], cp=2, tp=1)
    jobs[2]["radix"] = dict(two, prompts=SHARED, engine={"kv_pages": RADIX_POOL})
    jobs[2]["chunked"] = dict(two, engine={"prefill_chunk": 8, "kv_pages": SPREAD[2]})
    jobs[2]["spread"] = dict(two, engine={"kv_pages": SPREAD[2]})
    for fault, (kvd, _sound) in FAULTS.items():
        jobs[2][fault] = dict(two, fault=fault, engine={"kv_pages": SPREAD[2]})
        if kvd == "int8":
            jobs[2][fault].update(model_kw=dict(KW, kv_cache_dtype="int8"), state=state8)
    for name, (cp, n) in (("packet_cp2", (2, 1)), ("packet_tp2", (1, 2))):
        jobs[2][name] = dict(base, kind="packet", ranks=[0, 1], cp=cp, tp=n,
                             prompt=PACKET_PROMPT)
    for name, (world, groups, shapes) in HANDOFFS.items():
        jobs[world][name] = dict(base, kind="router", groups=groups, shapes=shapes)
    out = {w: torchrun.spawn(ranks.run, w, "gloo", "cpu", tmp / f"store{w}",
                             args=(w, jobs[w]), timeout=420) for w in (2, 4)}
    # the port's own cp=1 engine: chaos counts
    tm = get_model("causal_lm", device="cpu", dtype=torch.float32, **KW)
    inj = FaultInjector(FaultPlan(faults=()))
    eng = InferenceEngine(tm, {k: torch.from_numpy(v) for k, v in state.items()}, slots=2,
                          max_len=MAX_LEN, device="cpu", kv_page_size=8, chaos=inj,
                          scheduler=FIFOScheduler(max_len=MAX_LEN, buckets=(16,),
                                                  max_queue=len(PROMPTS)))
    for p in PROMPTS:
        eng.submit(p, max_new=6)
    eng.run()
    return {"ranks": out, "chaos_cp1": (inj.events("serving-admit"), inj.events("serving-step"))}


def _leader(port, world, name):
    return port["ranks"][world][0][name]


def _followers(port, world, name):
    return [r[name] for r in port["ranks"][world][1:] if r[name] is not None]


# ---------------------------------------------------------------- parity


def test_ranks_import_no_jax(port):
    assert all(not r["forbidden"] for w in (2, 4) for r in port["ranks"][w])


@pytest.mark.parametrize("i", range(len(CASES)), ids=CASE_IDS)
def test_cp_parity(port, jax_refs, i):
    """JAX's curated composition slice: the port's cp=N stream equals JAX's
    cp=1 paged engine's for the case's KV dtype on the case's pool (past
    case 0, one that puts pages of the second slot on a later cp row), and
    every follower made the leader's windows (or verify windows) on its
    pages and heads."""
    cp, n, kvd, spec = CASES[i]
    lead = _leader(port, cp * n, f"case{i}")
    assert lead["streams"] == jax_refs["streams"][(kvd, CASE_POOLS[i])]
    assert lead["summary"]["cp"] == cp and lead["summary"]["tp"] == n
    for f in _followers(port, cp * n, f"case{i}"):
        assert f["follow"]["ops"]["verify" if spec else "window"] > 0
        assert f["follow"]["ops"]["prefill"] >= len(PROMPTS)  # case 0 also prewarms


def test_cp2_equals_jaxs_own_cp2_engine(port, jax_refs):
    """Case 0 against JAX's own cp=2 engine on the eight-virtual-device
    platform: the tokens, and each rank's KV bytes at the default pool (9
    pages rounded up to 10, 5 a rank)."""
    want = jax_refs["cp2_engine"]
    assert _leader(port, 2, "case0")["streams"] == want["streams"]
    assert want["kv_pages"] == 10
    for r in port["ranks"][2]:
        assert r["case0"]["kv_bytes"] == want["kv"] and r["case0"]["pool_pages"] == 5


def test_mesh_is_jaxs_cp_by_tp_grid(port, jax_refs):
    """The (cp, tp) grid lays ranks out row-major as JAX's ``serving_mesh``
    lays devices: cp row ``r`` holds ``ranks[r * tp:(r + 1) * tp]``; the
    default pool at cp=4 rounds 9 pages up to JAX's 12."""
    mesh = jtp.serving_mesh(2, jax.devices()[:4], cp=2)
    for place, r in enumerate(port["ranks"][4]):
        row, col, members = r["case4"]["grid"]
        assert members == [0, 1, 2, 3] and (row, col) == divmod(place, 2)
        assert mesh.devices[row, col] == jax.devices()[place]
    assert jax_refs["kv_pages_cp4"] == 12
    assert all(r["default_cp4"]["pool_pages"] == 3 for r in port["ranks"][4])


# ---------------------------------------------------------------- memory


@pytest.mark.parametrize("name", list(MEMORY))
def test_per_rank_kv_bytes_equal_jaxs_per_chip_bytes(port, jax_refs, name):
    """At a fixed pool of 16 pages every rank's KV bytes are JAX's
    ``per_chip_bytes`` (its cp row's pages of its heads, the block tables
    and cursors whole), within JAX's own 0.9-1.1 x (cp * tp) of cp=1's."""
    cp, n = MEMORY[name]
    want = jax_refs["bytes"][name]
    assert all(r[name]["kv_bytes"] == want for r in port["ranks"][cp * n])
    assert 0.9 * cp * n <= jax_refs["bytes"]["cp1"] / want <= 1.1 * cp * n


def test_stats_cp_merges_into_rollup_as_jaxs():
    """``ServingStats.merge`` of cp-stamped records equals JAX's: the
    homogeneous cp, cluster bytes over every chip, mixed cp -> None."""
    def stamped(cls, stamps):
        out = []
        for s in stamps:
            st = cls(2)
            if s is not None:
                st.memory(tp=1, kv_bytes_per_chip=s[1], weight_bytes_per_chip=1000, cp=s[0])
            out.append(st)
        return out

    keys = ("cp", "tp", "kv_bytes_cluster", "kv_bytes_per_chip", "weight_bytes_cluster")
    for stamps in ([(2, 100), (2, 80)], [None], [(2, 100), (4, 80)]):
        got = ServingStats.merge(stamped(ServingStats, stamps))
        want = JaxStats.merge(stamped(JaxStats, stamps))
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}


# ---------------------------------------------------------------- operations


def test_prewarm_under_cp_then_no_build_on_any_rank(port, jax_refs):
    """prewarm's sites are cp-qualified as JAX's (``prefill[b16,cp2]``,
    ``first_pick[cp2]``), and no rank builds anything after it."""
    lead = _leader(port, 2, "case0")
    assert "prefill[b16,cp2]" in lead["prewarm_sites"]
    assert "first_pick[cp2]" in lead["prewarm_sites"]
    assert all(s.endswith(",cp2]") or s.endswith("[cp2]") for s in lead["prewarm_sites"])
    assert lead["builds_after_prewarm"] == 0 and lead["streams"] == jax_refs["native"]
    for f in _followers(port, 2, "case0"):
        assert f["follow"]["compile_since"]["prewarm"]["n_compiled_programs"] == 0


def test_chaos_event_counts_cp_invariant(port, jax_refs):
    counts = {1: port["chaos_cp1"], 2: _leader(port, 2, "case0")["chaos"],
              4: _leader(port, 4, "case3")["chaos"]}
    assert counts[1] == counts[2] == counts[4] == jax_refs["chaos"], counts
    assert counts[1][0] >= len(PROMPTS) and counts[1][1] > 0


def test_ring_hop_spans_carry_jaxs_comm_bytes(port):
    """cp - 1 = 1 ``ring_hop`` span a prefill (4 prompts), each with JAX's
    analytic bytes (its ``ring_hop_bytes`` at the grouped H_kv width, every
    layer) and JAX's uniform-slice timing."""
    hops = _leader(port, 2, "case0")["hops"]
    want = jax_hop_bytes(16 // 2, KW["heads"], KW["dim"] // KW["heads"], dtype_bytes=4,
                         depth=KW["depth"])
    assert want == ring_hop_bytes(16 // 2, KW["heads"], KW["dim"] // KW["heads"],
                                  dtype_bytes=4, depth=KW["depth"])
    assert len(hops) == len(PROMPTS)
    for cat, args in hops:
        assert cat == "serving" and args == {"hop": 0, "comm_bytes": want,
                                             "timing": "uniform-slice"}


def test_radix_and_chunked_prefill_compose_at_cp2(port, jax_refs):
    """Radix hits (the shared head's page on cp row 0, extended over on row
    1 through the merged decode attention) and chunked prefill (chunks of 8
    through the extend, the second slot's on row 1) give JAX's cp=1 streams
    on the same pools."""
    radix = _leader(port, 2, "radix")
    assert radix["streams"] == jax_refs["shared"]
    assert radix["summary"]["radix_hits"] == len(SHARED) - 1
    chunked = _leader(port, 2, "chunked")
    assert chunked["streams"] == jax_refs["streams"][("native", SPREAD[2])]
    assert chunked["summary"]["n_prefill_chunks"] >= len(PROMPTS)


def _differing(streams, want) -> int:
    return sum(x != y for a, b in zip(streams, want) for x, y in zip(a, b))


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_move_the_streams(port, jax_refs, fault):
    """The faults this file must catch: a decode merge that drops cp rank
    1's partial, an insert that writes every page of a prefilled row on the
    next cp row, and an int8 insert that writes only the scale pages there;
    each moves the streams, the sound run on the same pool of 6 pages (the
    second slot's pages on cp row 1) none."""
    kvd, sound_job = FAULTS[fault]
    want = jax_refs["streams"][(kvd, SPREAD[2])]
    sound = _differing(_leader(port, 2, sound_job)["streams"], want)
    planted = _differing(_leader(port, 2, fault)["streams"], want)
    assert sound == 0 and planted > 0, (sound, planted)


# ---------------------------------------------------------------- handoff


@pytest.mark.parametrize("name", list(HANDOFFS))
def test_handoff_across_tp_and_cp_equals_the_monolithic_stream(port, jax_refs, name):
    """A prefill replica hands every prompt off to a decode replica of
    another layout under the ``Router`` (the followers looping
    ``follow_engines``): the streams are the monolithic tp=1 stream, every
    prompt handed off once, no failover."""
    world, groups, _ = HANDOFFS[name]
    lead = _leader(port, world, name)
    assert lead["streams"] == jax_refs["native"], lead
    assert lead["statuses"] == ["done"] * len(PROMPTS)
    assert lead["handoffs"] == len(PROMPTS) and lead["failovers"] == 0
    followers = {r for g in groups for r in g[1:]}
    for r in followers:
        assert len(port["ranks"][world][r][name]["follow"]) == 1
    if name == "tp2_to_tp2":
        assert groups == tp.tp_device_groups(2, 2, devices=range(4), leader=0)
        assert not set(groups[0][1:]) & set(groups[1][1:])


@pytest.mark.parametrize("name", ["packet_cp2", "packet_tp2"])
def test_packet_assembled_over_the_mesh_equals_jaxs(port, jax_refs, name):
    """The packet a cp=2 or tp=2 prefill engine assembles from its ranks'
    pages and heads holds JAX's per-page trees (each page whole) and last
    logits at 1e-5."""
    got, want = _leader(port, 2, name), jax_refs["packet"]
    assert got["n_tok"] == want["n_tok"] and len(got["payloads"]) == len(want["payloads"]) == 2
    np.testing.assert_allclose(got["last_logits"], want["last_logits"], atol=ATOL, rtol=0)
    for tree, ref in zip(got["payloads"], want["payloads"]):
        leaves = [leaf for layer in tree.values() for leaf in layer.values()]
        assert [x.shape for x in leaves] == [x.shape for x in ref]
        for x, y in zip(leaves, ref):
            np.testing.assert_allclose(x, y, atol=ATOL, rtol=0)


# ---------------------------------------------------------------- the helpers


def _error(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def test_cp_refusals_are_jaxs():
    """JAX's refusals of cp > 1 (``tests/test_cp_serving.py:280-303``), word
    for word: cp=0, the dense layout, max_len % cp, an explicit kv_pages %
    cp and a model that carries an attn_fn; MoE blocks beside cp are served
    since item 7.7 (tests/test_torch_moe_mesh_serving.py), so outside a
    spawned world they ask for the launcher, as a dense model does."""
    jm, params = _jax_model()
    tm = get_model("causal_lm", device="cpu", dtype=torch.float32, **KW)
    cases = [dict(cp=0), dict(cp=2), dict(cp=3, kv_page_size=8),
             dict(cp=2, kv_page_size=8, kv_pages=9)]
    for kw in cases:
        want = _error(lambda: JaxEngine(jm, params, slots=2, max_len=MAX_LEN, scheduler=(
            JaxScheduler(max_len=MAX_LEN, buckets=(16,))), **kw))
        got = _error(lambda: InferenceEngine(tm, slots=2, max_len=MAX_LEN, device="cpu",
                                             scheduler=FIFOScheduler(max_len=MAX_LEN,
                                                                     buckets=(16,)), **kw))
        assert want is not None and got == want, kw
    want = _error(lambda: JaxEngine(jm.clone(attn_fn=jax_vanilla), params, slots=2,
                                    max_len=MAX_LEN, cp=2, kv_page_size=8))
    island = get_model("causal_lm", device="cpu", dtype=torch.float32,
                       attn_fn=vanilla_attention, **KW)
    got = _error(lambda: InferenceEngine(island, slots=2, max_len=MAX_LEN, device="cpu",
                                         cp=2, kv_page_size=8))
    assert want is not None and got == want
    moe = get_model("causal_lm", device="cpu", dtype=torch.float32, moe_every=2, **KW)
    assert "launch.torchrun" in _error(lambda: InferenceEngine(
        moe, slots=2, max_len=MAX_LEN, device="cpu", cp=2, kv_page_size=8))


def test_tp_device_groups_cp_match_jaxs():
    """cp x tp groups are JAX's disjoint carve, its errors its own; with a
    shared leader each group is the leader and cp * tp - 1 disjoint
    followers."""
    devs = list(range(8))
    for n_groups, n, cp in ((2, 2, 2), (1, 2, 4), (4, 1, 2), (2, 1, 4)):
        assert tp.tp_device_groups(n_groups, n, devices=devs, cp=cp) == \
            jtp.tp_device_groups(n_groups, n, devs, cp=cp)
    for kw in (dict(n_groups=3, tp=2, cp=2), dict(n_groups=2, tp=2, cp=4),
               dict(n_groups=2, tp=2, cp=0)):
        want = _error(lambda: jtp.tp_device_groups(kw["n_groups"], kw["tp"], devs, cp=kw["cp"]))
        assert _error(lambda: tp.tp_device_groups(devices=devs, **kw)) == want
    assert tp.tp_device_groups(2, 1, devices=range(3), cp=2, leader=0) == [[0, 1], [0, 2]]
    assert tp.tp_device_groups(1, 2, devices=range(4), cp=2, leader=0) == [[0, 1, 2, 3]]
    with pytest.raises(ValueError, match="needs"):
        tp.tp_device_groups(2, 2, devices=range(4), cp=2, leader=0)
