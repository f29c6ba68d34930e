"""The port's multi-replica tier (``serving/router.py``, ``serving/replica.py``)
and the engine's hooks, against the JAX package's, on converted weights.

Both sides serve float32 causal LMs (dim 32, depth 1, ``tests/test_router.py``'s
shapes) on the CPU, each replica its own copy of the weights.

* ROUTING: greedy output through two replicas is token-identical to JAX's
  router and to one fault-free engine, with the same replica per request;
  ``close()`` writes ONE strict-JSON ``router`` record with JAX's keys.
* FAILOVER: under the same ``FaultPlan`` (a ``router-dispatch`` hit and a
  ``serving-step`` kill) the same replica fails, the same requests are
  re-dispatched the same number of times, streams are exactly-once, and
  ``restart`` respawns the replica.
* HOT SWAP: a ``weight-swap`` chaos hit aborts one replica's swap, the
  retry covers exactly the straggler, traffic in flight drains with zero
  drops, the swapped tier serves JAX's new-weight tokens, and a restarted
  replica re-applies the current weights.
* WEIGHT WATCHER: over checkpoints the port's ``Trainer`` writes and then
  resumes, each poll rolls the newest intact step into every replica.
* ENGINE HOOKS: chaos sites fire on JAX's event indices, request span
  trees have JAX's names and parents, telemetry counts equal JAX's, and
  ``InferenceEngine.from_trainer`` / ``Trainer.generate`` equal JAX's on a
  converted state.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.core.trainer import Trainer as JaxTrainer
from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.serving import FIFOScheduler as JaxScheduler
from distributed_tensorflow_ibm_mnist_tpu.serving import InferenceEngine as JaxEngine
from distributed_tensorflow_ibm_mnist_tpu.serving import Router as JaxRouter
from distributed_tensorflow_ibm_mnist_tpu.utils import chaos as jchaos
from distributed_tensorflow_ibm_mnist_tpu.utils import telemetry as jtel
from distributed_tensorflow_ibm_mnist_tpu.utils import tracing as jtr
from distributed_tensorflow_ibm_mnist_tpu.utils.config import RunConfig as JaxRunConfig
from distributed_tensorflow_ibm_mnist_tpu.utils.metrics import MetricWriter as JaxWriter
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import causal_lm_state_dict
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.models import CausalLM
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import (
    FIFOScheduler,
    InferenceEngine,
    NoHealthyReplica,
    QueueFull,
    Router,
    WeightWatcher,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.utils import chaos as tchaos
from distributed_tensorflow_ibm_mnist_tpu_torch.utils import telemetry as ttel
from distributed_tensorflow_ibm_mnist_tpu_torch.utils import tracing as ttr
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.metrics import MetricWriter

torch.set_num_threads(1)

KW = dict(num_classes=16, dim=32, depth=1, heads=2)
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [2, 4, 6], [9, 1], [3, 3, 3, 3]]


def _weights(seed=0, scale=1.0):
    """JAX params and the port's state_dict of the same weights."""
    jm = jax_get_model("causal_lm", **KW, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(lambda x: x * scale, params)
    return jm, params, causal_lm_state_dict(jax.tree.map(np.asarray, params), KW)


def _port_factory(sd, **kw):
    def make_engine(tid):  # a model of its own: a swap must not reach a sibling
        return InferenceEngine(
            CausalLM(device="cpu", dtype=torch.float32, **KW), sd, slots=2, max_len=16,
            scheduler=FIFOScheduler(max_len=16, buckets=(8,), max_queue=16),
            trace_tid=tid, device="cpu", **kw)
    return make_engine


def _jax_factory(jm, params, **kw):
    def make_engine(tid):
        return JaxEngine(jm, params, slots=2, max_len=16,
                         scheduler=JaxScheduler(max_len=16, buckets=(8,), max_queue=16),
                         trace_tid=tid, **kw)
    return make_engine


def _reference(sd, prompts=PROMPTS, max_new=6):
    eng = _port_factory(sd)(0)
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.run()
    eng.close()
    return [list(r.generated) for r in reqs]


def _plan(mod, *faults, seed=0):
    return mod.FaultInjector(mod.FaultPlan(seed=seed, faults=tuple(
        mod.FaultSpec(site=s, kind=k, at=at) for s, k, at in faults)))


def _strict(line: str) -> dict:
    def reject(tok):
        raise ValueError(f"non-strict JSON token {tok}")
    return json.loads(line, parse_constant=reject)


# ----------------------------------------------------------------- routing


def test_router_parity_replicas_and_one_router_record(tmp_path):
    jm, params, sd = _weights()
    want = _reference(sd)
    records = {}
    for name, mk, writer_cls in (("torch", _port_factory(sd), MetricWriter),
                                 ("jax", _jax_factory(jm, params), JaxWriter)):
        path = tmp_path / f"{name}.jsonl"
        writer = writer_cls(path=str(path), stdout=False)
        r = (Router if name == "torch" else JaxRouter)(mk, 2, writer=writer)
        rrs = [r.submit(p, max_new=6) for p in PROMPTS]
        r.run_until_done(max_steps=500)
        r.close()
        r.close()  # idempotent: still one record
        writer.close()
        lines = [_strict(line) for line in path.read_text().splitlines()]
        assert [rec["kind"] for rec in lines] == ["router"]
        records[name] = (lines[0], [(list(rr.generated), rr.replica, rr.status) for rr in rrs])
    (got, got_rrs), (jgot, jax_rrs) = records["torch"], records["jax"]
    assert got_rrs == jax_rrs
    assert [g for g, _, _ in got_rrs] == want
    assert {rep for _, rep, _ in got_rrs} == {0, 1}
    assert set(got) == set(jgot)
    for key in ("n_replicas", "router_requests", "n_requests", "n_done", "n_engines",
                "tokens_generated", "failovers", "redispatches", "weight_swaps",
                "swapped_steps", "replicas_failed", "handoffs", "slots", "decode_steps",
                "n_windows", "window_steps"):
        assert got[key] == jgot[key], key
    for key in ("n_engines", "n_requests", "n_done", "tokens_generated"):
        assert got["per_role"]["both"][key] == jgot["per_role"]["both"][key], key
    assert got["n_compiled_programs"] == 0  # no kernel build on the CPU


def test_backpressure_no_healthy_and_refused_knobs():
    _, _, sd = _weights()

    def tiny(tid):
        return InferenceEngine(
            CausalLM(device="cpu", dtype=torch.float32, **KW), sd, slots=1, max_len=16,
            scheduler=FIFOScheduler(max_len=16, buckets=(8,), max_queue=1),
            trace_tid=tid, device="cpu")

    r = Router(tiny, 2)
    for _ in range(2):
        r.submit([1, 2], max_new=4)
    with pytest.raises(QueueFull):
        r.submit([1, 2], max_new=4)
    r.run_until_done(max_steps=500)
    for rep in r.replicas:
        rep.state = "failed"
    with pytest.raises(NoHealthyReplica):
        r.submit([1, 2], max_new=4)
    for rep in r.replicas:
        rep.state = "healthy"
    r.close()
    with pytest.raises(RuntimeError, match="closed"):
        r.submit([1, 2], max_new=4)
    # roles= is ported (tests/test_torch_disagg.py): JAX's refusals stay
    with pytest.raises(ValueError, match="roles has 1 entries"):
        Router(tiny, 2, roles=["prefill"])
    with pytest.raises(RuntimeError, match="role"):
        Router(tiny, 2, roles=["prefill", "decode"])   # a "both" engine
    with pytest.raises(ValueError):
        Router(tiny, 0)


# ----------------------------------------------------------------- failover


def test_failover_under_the_same_fault_plan_is_exactly_once():
    jm, params, sd = _weights()
    want = _reference(sd)
    # the dispatch hit bars replica 0 for request 2 (it lands on replica 1);
    # the step kill is replica 0's first window
    faults = (("router-dispatch", "io", (2,)), ("serving-step", "transient", (0,)))
    out = {}
    for name in ("torch", "jax"):
        mod = tchaos if name == "torch" else jchaos
        inj = _plan(mod, *faults)
        mk = (_port_factory(sd, chaos=inj) if name == "torch"
              else _jax_factory(jm, params, chaos=inj))
        streams: dict[int, list[int]] = {}
        r = (Router if name == "torch" else JaxRouter)(mk, 2, chaos=inj)
        rrs = [r.submit(p, max_new=6, callback=lambda rr, tok: streams.setdefault(
            rr.id, []).append(int(tok))) for p in PROMPTS]
        r.run_until_done(max_steps=500)
        failed = [rep.index for rep in r.replicas if rep.state == "failed"]
        summ = r.summary()
        spawn = r.restart(failed[0])
        assert spawn > 0 and r.replicas[failed[0]].spawns == 2
        again = r.submit(PROMPTS[0], max_new=6)
        r.run_until_done(max_steps=500)
        out[name] = dict(
            tokens=[list(rr.generated) for rr in rrs],
            status=[rr.status for rr in rrs],
            replica=[rr.replica for rr in rrs],
            redispatches=[rr.redispatches for rr in rrs],
            excluded=[sorted(rr.excluded) for rr in rrs],
            attempts=[[i for i, _ in rr.attempts] for rr in rrs],
            exactly_once=all(streams.get(rr.id, []) == list(rr.generated) for rr in rrs),
            failed=failed, failovers=r.failovers,
            counts={k: summ[k] for k in ("n_requests", "n_engine_fault", "n_done",
                                         "replicas_failed", "redispatches")},
            chaos=inj.summary(), again=(list(again.generated), again.status))
        r.close()
    assert out["torch"] == out["jax"]
    assert out["torch"]["tokens"] == want
    assert out["torch"]["failovers"] == 1 and out["torch"]["exactly_once"]
    assert sum(out["torch"]["redispatches"]) >= 2  # the dispatch hit + the harvest
    assert out["torch"]["again"] == (want[0], "done")


# ----------------------------------------------------------------- hot swap


def test_hot_swap_chaos_abort_straggler_retry_and_restart():
    jm, params, sd = _weights()
    _, params2, sd2 = _weights(scale=1.1)
    want_new = _reference(sd2)
    out = {}
    for name in ("torch", "jax"):
        mod = tchaos if name == "torch" else jchaos
        inj = _plan(mod, ("weight-swap", "io", (0,)))
        if name == "torch":
            r, new = Router(_port_factory(sd), 2, chaos=inj), sd2
        else:
            r, new = JaxRouter(_jax_factory(jm, params), 2, chaos=inj), params2
        inflight = r.submit(PROMPTS[0], max_new=8)
        first = r.hot_swap(new, step=3)          # one replica aborted by chaos
        stamps = [rep.weight_step for rep in r.replicas]
        assert inflight.status == "done"          # drained, never dropped
        second = r.hot_swap(new, step=3)         # exactly the straggler
        rrs = [r.submit(p, max_new=6) for p in PROMPTS]
        r.run_until_done(max_steps=500)
        r.replicas[0].close()
        r.replicas[0].state = "failed"
        r.restart(0)
        restarted = r.replicas[0].weight_step
        r.replicas[1].close()                    # pin the restarted replica
        r.replicas[1].state = "failed"
        pinned = r.submit(PROMPTS[2], max_new=6)
        r.run_until_done(max_steps=500)
        out[name] = dict(
            swaps=(first, second, stamps, [rep.swaps for rep in r.replicas],
                   list(r.swapped_steps), restarted),
            inflight=list(inflight.generated),
            wave=[list(rr.generated) for rr in rrs],
            pinned=(pinned.replica, list(pinned.generated)))
        r.close()
    assert out["torch"] == out["jax"]
    first, second, stamps, swaps, steps, restarted = out["torch"]["swaps"]
    assert (first, second, swaps, steps, restarted) == (1, 1, [1, 1], [3], 3)
    assert sorted(stamps, key=str) == [3, None]
    assert out["torch"]["wave"] == want_new
    assert out["torch"]["pinned"] == (0, want_new[2])


def _lm_cfg(tmp_path, **kw):
    base = dict(model="causal_lm", dataset="retrieval",
                model_kwargs={**{k: KW[k] for k in ("dim", "depth", "heads")},
                              "dtype": torch.float32},
                dataset_kwargs={"vocab": 16, "seq_len": 12}, n_train=64, n_test=16,
                batch_size=16, epochs=1, quiet=True, eval_batch_size=8,
                checkpoint_dir=str(tmp_path / "ck"), lr=3e-3)
    return RunConfig(**{**base, **kw})


def test_weight_watcher_rolls_out_the_port_trainers_checkpoints(tmp_path):
    trainer = Trainer(_lm_cfg(tmp_path), device="cpu")
    trainer.fit()
    step1 = trainer.state.step
    r = Router(lambda tid: InferenceEngine.from_trainer(
        trainer, slots=2, max_len=16, buckets=(8,), trace_tid=tid, writer=None), 2)
    w = WeightWatcher(str(tmp_path / "ck"), None, r)
    assert w.poll() == step1 and w.last_step == step1
    assert all(rep.weight_step == step1 for rep in r.replicas)
    assert w.poll() is None                   # nothing new
    trainer.close()

    resumed = Trainer(_lm_cfg(tmp_path, resume=True), device="cpu")
    resumed.fit()                             # resumes at step1, one more epoch
    step2 = resumed.state.step
    assert step2 == 2 * step1
    rr = r.submit(PROMPTS[0], max_new=4)      # in flight through the swap
    assert w.poll() == step2
    r.run_until_done(max_steps=500)
    assert rr.status == "done" and r.swapped_steps == [step1, step2]
    after = [r.submit(p, max_new=4) for p in PROMPTS[:3]]
    r.run_until_done(max_steps=500)
    want = [resumed.generate(np.asarray(p), 4)[0, len(p):].tolist() for p in PROMPTS[:3]]
    assert [list(a.generated) for a in after] == want
    r.close()
    resumed.close()


# ----------------------------------------------------------------- engine hooks


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001
        return self.t


def _tree(tracer) -> list:
    """Every request-track span and instant of a tracer as (track name,
    name, parent name, status), sorted; build and compile events left out."""
    evs = [e for e in tracer.events() if e["type"] != "counter" and e["cat"] != "compile"]
    names = {e["id"]: e["name"] for e in evs}
    tracks = tracer._track_names
    return sorted((tracks[e["tid"]], e["name"], names.get(e["parent"]),
                   (e["args"] or {}).get("status")) for e in evs)


def test_engine_chaos_sites_spans_and_telemetry_match_jax():
    jm, params, sd = _weights()
    faults = (("serving-admit", "poison", (2,)), ("serving-callback", "raise", (7,)))
    out = {}
    for name in ("torch", "jax"):
        tr_mod, tel_mod, ch_mod = ((ttr, ttel, tchaos) if name == "torch"
                                   else (jtr, jtel, jchaos))
        clock = _Clock()
        tracer, inj = tr_mod.Tracer(clock=clock), _plan(ch_mod, *faults)
        tel = tel_mod.Telemetry(interval_s=1e9, clock=clock)
        kw = dict(slots=2, max_len=16, chaos=inj, tracer=tracer, telemetry=tel,
                  trace_tid=tracer.track("engine"), clock=clock,
                  scheduler=(FIFOScheduler if name == "torch" else JaxScheduler)(
                      max_len=16, buckets=(8,), clock=clock))
        if name == "torch":
            eng = InferenceEngine(CausalLM(device="cpu", dtype=torch.float32, **KW), sd,
                                  device="cpu", **kw)
        else:
            eng = JaxEngine(jm, params, **kw)
        reqs = [eng.submit(p, max_new=6, ttft_slo_s=1.0, tpot_slo_s=1e-6) for p in PROMPTS]
        eng.run()
        eng.close()
        snap = tel.registry.snapshot()
        summ = tracer.summary()
        out[name] = dict(
            status=[(r.status, r.error is not None and "chaos" in r.error,
                     list(r.generated), r.slo_ttft_ok, r.slo_tpot_ok) for r in reqs],
            chaos=inj.summary(), tree=_tree(tracer), open=tracer.open_spans,
            counters=snap["counters"],
            hist={k: v["count"] for k, v in snap["histograms"].items()},
            phases={k: v["n"] for k, v in summ["phases"].items()},
            slo={k: eng.stats.summary()[k] for k in (
                "slo_tracked", "slo_met", "slo_miss", "slo_ttft_miss", "slo_tpot_miss")},
            vitals=set(tel.sample()["sources"]["engine" + str(eng._trace_tid)]))
    assert out["torch"] == out["jax"]
    got = out["torch"]
    assert [s[0] for s in got["status"]].count("failed") == 2 and got["open"] == 0
    assert got["chaos"]["by_site"] == {"serving-admit": 1, "serving-callback": 1}
    assert ("engine", "window", None, None) in got["tree"]
    assert got["counters"]["tokens_generated"] == sum(len(s[2]) for s in got["status"])


def _trainer_cfgs():
    common = dict(model="causal_lm", dataset="retrieval",
                  dataset_kwargs={"vocab": 16, "seq_len": 12}, n_train=32, n_test=16,
                  batch_size=16, epochs=1, quiet=True, seed=3)
    dims = {k: KW[k] for k in ("dim", "depth", "heads")}
    return (RunConfig(**common, model_kwargs={**dims, "dtype": torch.float32}),
            JaxRunConfig(**common, model_kwargs={**dims, "dtype": jnp.float32}))


def test_from_trainer_and_generate_equal_jax_on_a_converted_state():
    cfg, jcfg = _trainer_cfgs()
    jt = JaxTrainer(jcfg)
    pt = Trainer(cfg, device="cpu")
    sd = causal_lm_state_dict(jax.tree.map(np.asarray, jt.state.params), KW)
    pt.model.load_state_dict(sd)
    pt._gen_params = None
    prompts = np.array([[5, 6, 7, 8], [1, 2, 0, 0]], np.int32)
    lens = np.array([4, 2], np.int32)
    got = pt.generate(prompts, 6, max_len=16, prompt_lens=lens, with_lengths=True,
                      eos_id=3, pad_id=0)
    want = jt.generate(jnp.asarray(prompts), 6, max_len=16, prompt_lens=jnp.asarray(lens),
                       with_lengths=True, eos_id=3, pad_id=0)
    assert got[0].tolist() == np.asarray(want[0]).tolist()
    assert got[1].tolist() == np.asarray(want[1]).tolist()
    assert pt.generate(prompts[0], 5).tolist() == np.asarray(jt.generate(prompts[0], 5)).tolist()
    with pytest.raises(ValueError, match="GSPMD"):
        pt.generate(prompts[0], 5, on_mesh=True)
    streams = []
    for eng in (InferenceEngine.from_trainer(pt, slots=2, max_len=16, buckets=(8,)),
                JaxEngine.from_trainer(jt, slots=2, max_len=16, buckets=(8,))):
        reqs = [eng.submit(p, max_new=6) for p in PROMPTS]
        eng.run()
        eng.close()
        streams.append([list(r.generated) for r in reqs])
    assert streams[0] == streams[1]
    pt.close()
    jt.close()
