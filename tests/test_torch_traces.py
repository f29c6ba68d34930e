"""The port's arrival traces (``serving/traces.py``) against the JAX
package's, on the CPU.

* Every generator (Poisson, bursty, diurnal, heavy-tail) gives, for the
  same seed and knobs, JAX's trace event for event (exact: both sides are
  the same numpy draws), and its own invariants hold: deterministic,
  sorted, lengths inside their clip bounds, both classes present.
* The JSONL artifact is JAX's: a trace the port saves loads in JAX and
  back, byte-identical files; ``with_slos`` stamps the same SLOs; the
  schema and truncation checks refuse what JAX refuses.
* ``per_class_report`` gives JAX's report on the same outcomes, exactly
  (including the exactly-once and SLO verdicts).
* ``replay_trace`` drives the port's daemon open-loop: every accepted
  request done, exactly-once, conservation exact.
"""

import dataclasses

import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.serving import traces as jtr
from distributed_tensorflow_ibm_mnist_tpu_torch.models import CausalLM
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import (
    FIFOScheduler,
    InferenceEngine,
    Router,
    ServingDaemon,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import traces as ttr

torch.set_num_threads(1)

WAIT_S = 60.0
GENERATORS = [
    ("poisson_trace", dict(rate_rps=5.0)),
    ("bursty_trace", dict(base_rps=2.0, burst_rps=25.0, burst_every_s=1.0,
                          burst_len_s=0.25)),
    ("diurnal_trace", dict(mean_rps=5.0, period_s=4.0, depth=0.8)),
    ("heavy_tail_trace", dict(rate_rps=5.0, alpha=1.5)),
]


def _events(trace):
    return [dataclasses.asdict(e) for e in trace.events]


@pytest.mark.parametrize("name,kw", GENERATORS, ids=[g[0] for g in GENERATORS])
@pytest.mark.parametrize("seed", [0, 7])
def test_generators_equal_jax_event_for_event(name, kw, seed):
    port = getattr(ttr, name)(40, seed=seed, **kw)
    ref = getattr(jtr, name)(40, seed=seed, **kw)
    assert port.name == ref.name
    assert _events(port) == _events(ref)
    # the generator's own invariants
    assert _events(getattr(ttr, name)(40, seed=seed, **kw)) == _events(port)
    offs = [e.t_offset for e in port.events]
    assert offs == sorted(offs) and len(port) == 40
    lo_p, hi_p = (2, 8) if name == "heavy_tail_trace" else (2, 6)
    lo_m, hi_m = (2, 8) if name == "heavy_tail_trace" else (2, 4)
    assert all(lo_p <= e.prompt_len <= hi_p and lo_m <= e.max_new <= hi_m
               for e in port.events)
    counts = port.class_counts()
    assert counts == ref.class_counts() and min(counts.values()) > 0
    assert port.duration_s == ref.duration_s


def test_jsonl_artifact_and_slo_stamping_are_jaxs(tmp_path):
    trace = ttr.bursty_trace(12, 2.0, 20.0, seed=3, burst_every_s=1.0,
                             burst_len_s=0.3)
    a = trace.save(tmp_path / "port.jsonl")
    b = jtr.bursty_trace(12, 2.0, 20.0, seed=3, burst_every_s=1.0,
                         burst_len_s=0.3).save(tmp_path / "jax.jsonl")
    assert a.read_bytes() == b.read_bytes()
    assert _events(jtr.ArrivalTrace.load(a)) == _events(trace)
    assert _events(ttr.ArrivalTrace.load(b)) == _events(trace)
    kw = dict(interactive_ttft_slo_s=0.5, batch_ttft_slo_s=2.0,
              interactive_tpot_slo_s=0.1)
    stamped = ttr.with_slos(trace, **kw)
    assert _events(stamped) == _events(jtr.with_slos(jtr.ArrivalTrace.load(b), **kw))
    assert all(e.ttft_slo_s is None for e in trace.events)  # shape stays bare
    # refusals: JAX's
    lines = a.read_text().splitlines()
    (tmp_path / "short.jsonl").write_text("\n".join(lines[:-2]) + "\n")
    with pytest.raises(ValueError, match="truncated"):
        ttr.ArrivalTrace.load(tmp_path / "short.jsonl")
    (tmp_path / "other.jsonl").write_text('{"schema": "nope"}\n')
    with pytest.raises(ValueError, match="not an arrival trace"):
        ttr.ArrivalTrace.load(tmp_path / "other.jsonl")
    for bad in (dict(t_offset=-1.0, prompt_len=2, max_new=2),
                dict(t_offset=0.0, prompt_len=0, max_new=2),
                dict(t_offset=0.0, prompt_len=2, max_new=2, cls="bulk")):
        with pytest.raises(ValueError):
            ttr.TraceEvent(**bad)
    with pytest.raises(ValueError, match="burst_rps"):
        ttr.bursty_trace(4, 5.0, 5.0, seed=0, burst_every_s=1.0, burst_len_s=0.1)
    with pytest.raises(ValueError, match="depth"):
        ttr.diurnal_trace(4, 5.0, seed=0, period_s=1.0, depth=1.0)
    with pytest.raises(ValueError, match="alpha"):
        ttr.heavy_tail_trace(4, 5.0, seed=0, alpha=1.0)


class _Req:
    def __init__(self, finish_t, first_token_t):
        self.finish_t, self.first_token_t = finish_t, first_token_t


class _RR:
    def __init__(self, req):
        self.req = req


class _DR:
    """The fields per_class_report reads off a DaemonRequest."""

    def __init__(self, status, tokens, submit_t, first_token_t, req=None):
        self.done = status is not None
        self.status = status
        self.tokens = tokens
        self.submit_t = submit_t
        self.first_token_t = first_token_t
        self.rr = _RR(req) if req is not None else None


def test_per_class_report_is_jaxs():
    ev = ttr.TraceEvent
    i, b = ttr.INTERACTIVE, ttr.BATCH
    outcomes = [
        (ev(0.0, 2, 3, i, 1, 0.5, 0.2), _DR("done", [1, 2, 3], 0.0, 0.2, _Req(0.5, 0.2)), [1, 2, 3]),
        (ev(0.1, 2, 3, i, 1, 0.1, None), _DR("done", [4, 5], 0.0, 0.3), [4, 5]),
        (ev(0.2, 2, 3, i, 1, 0.5, 0.01), _DR("done", [1, 2], 0.0, 0.1, _Req(0.9, 0.1)), [1, 2]),
        (ev(0.3, 2, 3, b), None, []),
        (ev(0.4, 2, 3, b), _DR("cancelled", [1], 0.0, 0.1), [1]),
        (ev(0.5, 2, 3, b), _DR("failed", [], 0.0, None), []),
        (ev(0.6, 2, 3, b), _DR(None, [], 0.0, None), []),
        (ev(0.7, 2, 3, b), _DR("done", [7, 8], 0.0, 0.4), [7]),  # a lost token
        (ev(0.8, 2, 3, b, 0, 1.0), _DR("done", [7], 0.0, None), [7]),
    ]
    got = ttr.per_class_report(outcomes, 2.0)
    assert got == jtr.per_class_report(outcomes, 2.0)
    assert got["total"]["offered"] == 9 and got["total"]["rejected"] == 1
    assert got["per_class"][i]["slo_met"] == 1
    assert got["total"]["exactly_once"] is False


def test_replay_trace_against_the_ports_daemon():
    kw = dict(num_classes=16, dim=32, depth=1, heads=2)
    sd = CausalLM(device="cpu", dtype=torch.float32, **kw).state_dict()

    def make_engine(tid):
        return InferenceEngine(
            CausalLM(device="cpu", dtype=torch.float32, **kw), sd, slots=2,
            max_len=16, kv_page_size=4,
            scheduler=FIFOScheduler(max_len=16, buckets=(8,), max_queue=16),
            trace_tid=tid, device="cpu")

    daemon = ServingDaemon(Router(make_engine, 2), max_queue=64).start()
    try:
        trace = ttr.with_slos(
            ttr.poisson_trace(10, 20.0, seed=11, prompt_len=(2, 5), max_new=(2, 4)),
            interactive_ttft_slo_s=30.0, batch_ttft_slo_s=30.0)
        rep = ttr.replay_trace(daemon, trace, vocab=16, seed=1, timeout_s=WAIT_S)
        tot = rep["total"]
        assert tot["offered"] == 10 and tot["unfinished"] == 0
        assert tot["done"] == tot["accepted"] == 10
        assert tot["exactly_once"] and tot["slo_met"] == tot["done"]
        assert daemon.conservation()["conserved"]
        assert daemon.drain(timeout=WAIT_S)
    finally:
        daemon.close()
    with pytest.raises(ValueError, match="speed"):
        ttr.replay_trace(daemon, trace, speed=0)
