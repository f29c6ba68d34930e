"""The port's ``utils/telemetry.py`` and ``serving/stats.py`` rollups
against the JAX package's.

* SKETCHES: on seeded values (under- and overflow, zero, negatives,
  non-finite) the bucket counts, exact min/max/sum, percentiles, bucket
  indices, ``to_dict``/``from_dict`` and ``merge`` equal JAX's; rolling
  windows rotate alike.
* EXPOSITION: ``to_prometheus`` and ``to_openmetrics`` (exemplars on a
  pinned wall clock) are byte-for-byte JAX's; registry ``snapshot``,
  ``to_dict`` and ``merge`` are equal.
* SAMPLER: ``maybe_sample`` on an injected clock writes JAX's JSONL lines
  and Prometheus file, a raising source recorded and never raised.
* SERVING ROLLUP: ``ServingStats`` fed the same request records (SLOs,
  sampling, cancels, failures, engine faults) gives JAX's ``summary``,
  ``vitals`` and ``merge`` (the port's records add only ``prefill_s`` and
  ``decode_s``), ``slo_verdict`` and ``transcript_digest`` agree, and the
  seeded percentile reservoir keeps the same records.  The port's stats
  use the telemetry sketch: there is one ``HistogramSketch``.
"""

import json
import math

import numpy as np
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.serving import sampling as jsampling
from distributed_tensorflow_ibm_mnist_tpu.serving import scheduler as jsched
from distributed_tensorflow_ibm_mnist_tpu.serving import stats as jstats
from distributed_tensorflow_ibm_mnist_tpu.utils import telemetry as jtel
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import sampling as tsampling
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import scheduler as tsched
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import stats as tstats
from distributed_tensorflow_ibm_mnist_tpu_torch.utils import telemetry as ttel

torch.set_num_threads(1)


def _values(seed, n=400):
    rng = np.random.default_rng(seed)
    xs = list(rng.lognormal(-3.0, 2.0, n))
    return xs + [0.0, -1.0, 1e-9, 2e4, float("nan"), float("inf"), 1e-6, 9999.99]


def _sketch_state(s):
    return (s.counts, s.underflow, s.overflow, s.nonfinite, s.count, s.sum,
            s.min, s.max, s.n_buckets)


QS = (0, 1, 25, 50, 90, 95, 99, 99.9, 100)


@pytest.mark.parametrize("kw", [{}, dict(lo=1e-4, hi=1e2), dict(lo=0.5, hi=64.0, growth=2.0)],
                         ids=["default", "nll", "coarse"])
def test_sketch_counts_percentiles_and_merge_equal_jax(kw):
    parts = []
    for seed in range(3):
        got, want = ttel.HistogramSketch(**kw), jtel.HistogramSketch(**kw)
        for v in _values(seed):
            got.record(v)
            want.record(v)
        assert _sketch_state(got) == _sketch_state(want)
        assert [got.percentile(q) for q in QS] == [want.percentile(q) for q in QS]
        assert got.percentiles() == want.percentiles()
        assert [got.bucket_index(v) for v in _values(seed, 20)] == [
            want.bucket_index(v) for v in _values(seed, 20)]
        assert got.to_dict() == want.to_dict()
        back = ttel.HistogramSketch.from_dict(json.loads(json.dumps(got.to_dict())))
        assert _sketch_state(back) == _sketch_state(
            jtel.HistogramSketch.from_dict(want.to_dict()))  # sum kept to 1e-9
        parts.append((got, want))
    merged = ttel.HistogramSketch.merge([g for g, _ in parts])
    jmerged = jtel.HistogramSketch.merge([w for _, w in parts])
    assert _sketch_state(merged) == _sketch_state(jmerged)
    assert [merged.percentile(q) for q in QS] == [jmerged.percentile(q) for q in QS]
    assert ttel.HistogramSketch().percentile(50) is None
    with pytest.raises(ValueError, match="bucket configs"):
        merged.merge_from(ttel.HistogramSketch(lo=1e-3))
    with pytest.raises(ValueError):
        merged.percentile(101)


def test_rolling_window_rotates_as_jax():
    got, want = ttel.RollingHistogram(window=3), jtel.RollingHistogram(window=3)
    for step, v in enumerate(_values(7, 60)):
        got.record(v)
        want.record(v)
        if step % 11 == 10:
            got.rotate()
            want.rotate()
            assert _sketch_state(got.window_sketch()) == _sketch_state(want.window_sketch())
    assert _sketch_state(got.lifetime) == _sketch_state(want.lifetime)


def _registry(mod):
    reg = mod.MetricsRegistry(window=2)
    reg.inc("tokens_generated", 5)
    reg.inc("tokens_generated")
    reg.inc("requests-done", 2.5)
    reg.set_gauge("queue_depth", 3)
    reg.set_gauge("draining", True)
    reg.set_gauge("last_progress_t", float("nan"))
    reg.set_gauge("name", "not a number")
    for i, v in enumerate(_values(11, 80)):
        reg.observe("ttft_s", v, exemplar=f"{i:032x}" if i % 7 == 0 else None)
        reg.observe("latency.s", v * 3)
        if i == 40:
            reg.rotate()
    reg.observe("ttft_s", 0.0, exemplar="f" * 32)   # an underflow exemplar
    reg.observe("ttft_s", 5e4, exemplar="e" * 32)   # the +Inf bucket's
    return reg


def test_prometheus_and_openmetrics_text_byte_equal_jax(monkeypatch):
    for mod in (ttel, jtel):  # the exemplars' wall-clock stamp, pinned
        monkeypatch.setattr(mod.time, "time", lambda: 1_700_000_000.25)
    got, want = _registry(ttel), _registry(jtel)
    extra = {"src_engine0_occupied": 2.0, "src_flag": True, "src_bad": float("inf")}
    assert got.to_prometheus() == want.to_prometheus()
    assert got.to_prometheus(prefix="x", extra_gauges=extra) == want.to_prometheus(
        prefix="x", extra_gauges=extra)
    text = got.to_openmetrics(extra_gauges=extra)
    assert text == want.to_openmetrics(extra_gauges=extra)
    assert text.endswith("# EOF\n") and ' # {trace_id="' in text
    assert got.snapshot() == want.snapshot()
    assert got.to_dict() == want.to_dict()
    dumps = [got.to_dict(), _registry(ttel).to_dict()]
    assert ttel.MetricsRegistry.merge(dumps) == jtel.MetricsRegistry.merge(dumps)


class _Clock:
    def __init__(self):
        self.t = 10.0

    def __call__(self):
        return self.t


def _sampler_run(mod, tmp_path, name):
    clock = _Clock()
    tel = mod.Telemetry(interval_s=0.5, jsonl_path=str(tmp_path / f"{name}.jsonl"),
                        prom_path=str(tmp_path / f"{name}.prom"), clock=clock,
                        window=2)
    calls = []
    tel.register_source("engine0", lambda: {"occupied": len(calls), "ok": True,
                                            "nested": {"a": 1.5, "b": None}})
    tel.register_source("sick", lambda: 1 / 0)
    records = []
    for step in range(12):
        calls.append(step)
        tel.inc("tokens_generated", step)
        tel.observe("ttft_s", 0.01 * (step + 1))
        tel.heartbeat("trainer")
        records.append(tel.maybe_sample())
        clock.t += 0.2
    tel.register_source("engine0", lambda: {"occupied": -1})  # a respawn replaces
    tel.unregister_source("sick")
    records.append(tel.sample())
    tel.close()
    tel.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        tel.sample()
    assert tel.maybe_sample() is None
    return records, tel


def test_maybe_sample_writes_jaxs_jsonl_and_prometheus_file(tmp_path):
    got, tel = _sampler_run(ttel, tmp_path, "torch")
    want, jtel_ = _sampler_run(jtel, tmp_path, "jax")
    assert got == want
    assert [r is None for r in got] == [r is None for r in want]
    assert tel.samples == jtel_.samples and tel.source_errors == jtel_.source_errors > 0
    assert (tmp_path / "torch.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()
    assert (tmp_path / "torch.prom").read_bytes() == (tmp_path / "jax.prom").read_bytes()
    lines = (tmp_path / "torch.jsonl").read_text().splitlines()
    assert all(json.loads(line) for line in lines)
    assert "ZeroDivisionError" in lines[0]
    with pytest.raises(ValueError):
        ttel.Telemetry(interval_s=0)
    with pytest.raises(ValueError, match="callable"):
        ttel.Telemetry().register_source("x", 3)


def _requests(sched, smod, seed, n):
    """``n`` request records with the same fields on either side: statuses,
    SLO verdicts, sampling, logprobs, timings, engine faults."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t0 = float(rng.uniform(0, 5))
        status = ["done", "done", "done", "cancelled", "failed"][int(rng.integers(5))]
        gen = rng.integers(1, 50, int(rng.integers(1, 9))).tolist()
        samp = [None, smod.SamplingParams(),
                smod.SamplingParams(temperature=float(rng.uniform(0.1, 1.2)), seed=i)][
            int(rng.integers(3))]
        r = sched.Request(
            id=i, tokens=np.arange(1, 4, dtype=np.int32), max_new=8, bucket=8,
            deadline_s=None, submit_t=t0,
            ttft_slo_s=[None, 0.05, 0.2][int(rng.integers(3))],
            tpot_slo_s=[None, 0.01][int(rng.integers(2))], sampling=samp)
        r.status = status
        r.generated = gen
        r.logprobs = list(-rng.exponential(0.8, len(gen)))
        if status != "cancelled" or rng.integers(2):
            r.admit_t = t0 + float(rng.uniform(0, 0.1))
            r.first_token_t = r.admit_t + float(rng.uniform(0, 0.2))
            r.finish_t = r.first_token_t + float(rng.uniform(0, 0.5))
            if r.ttft_slo_s is not None:
                r.slo_ttft_ok = r.first_token_t - r.submit_t <= r.ttft_slo_s
            if r.tpot_slo_s is not None and status == "done":
                r.slo_tpot_ok = bool(rng.integers(2))
        else:
            r.finish_t = t0 + 0.3
        r.engine_fault = status != "done" and bool(rng.integers(2))
        out.append(r)
    return out


def _fill(smod, sched, samp, seed, n, cap):
    st = smod.ServingStats(slots=2 + seed, decode_ahead=2, sample_cap=cap)
    for r in _requests(sched, samp, seed, n):
        st.add(r)
    for k in range(5):
        st.tick(occupied=k % 3, dt=0.01 * (k + 1), decoded=k % 2 == 0)
        st.window(0.001 * k, 0.002, steps=4, waste=k % 2)
        st.spec(3, k % 4)
    st.prefix(True)
    st.prefix(False)
    st.radix(True, tokens=16)
    st.radix(False)
    st.pool_sample(5 + seed, 33, 16, 4096)
    st.chunk(0.004)
    st.prompt_admitted(40 + seed)
    st.prefix_oversized(seed)
    return st


def test_serving_stats_merge_summary_and_slo_verdict_equal_jax():
    recs, jrecs = [], []
    for seed, (n, cap) in enumerate(((12, 2048), (20, 6), (0, 2048))):
        st = _fill(tstats, tsched, tsampling, seed, n, cap)
        st.memory(kv_bytes_per_chip=1000 + seed, weight_bytes_per_chip=2000)
        st.set_compile({"n_compiled_programs": seed, "n_loads": 1,
                        "compile_time_s": 0.5, "by_site": {}})
        st.prefill(0.25)
        st.decode(0.5)
        jst = _fill(jstats, jsched, jsampling, seed, n, cap)
        jst.memory(tp=1, kv_bytes_per_chip=1000 + seed, weight_bytes_per_chip=2000)
        jst.set_compile({"n_compiled_programs": seed, "compile_time_s": 0.5,
                         "by_site": {}})
        # the seeded reservoir keeps the same records
        assert [r.id for r in st.requests] == [r.id for r in jst.requests]
        extra = set(st.summary()) - set(jst.summary())
        assert extra == {"prefill_s", "decode_s"}
        assert {k: st.summary()[k] for k in jst.summary()} == jst.summary()
        assert st.vitals() == jst.vitals()
        recs.append(st)
        jrecs.append(jst)
    got, want = tstats.ServingStats.merge(recs), jstats.ServingStats.merge(jrecs)
    assert set(got) == set(want)
    for key in want:
        if key != "per_engine":
            assert got[key] == want[key], key
    for g, w in zip(got["per_engine"], want["per_engine"]):
        assert {k: g[k] for k in w} == w
    assert got["per_role"] == want["per_role"] and list(got["per_role"]) == ["both"]
    json.dumps(got, allow_nan=False)
    json.dumps(tstats.ServingStats.merge([]), allow_nan=False)
    for r, jr in zip(_requests(tsched, tsampling, 5, 30), _requests(jsched, jsampling, 5, 30)):
        assert tstats.slo_verdict(r) == jstats.slo_verdict(jr)
    for toks in ([], [1, 2, 3], list(range(300))):
        assert tstats.transcript_digest(toks) == jstats.transcript_digest(toks)


def test_the_port_has_one_histogram_sketch():
    assert tstats.HistogramSketch is ttel.HistogramSketch
    assert type(tstats.ServingStats(1)._nll) is ttel.HistogramSketch
    with pytest.raises(ValueError, match="sample_cap"):
        tstats.ServingStats(1, sample_cap=0)
    st = tstats.ServingStats(1)
    assert math.isclose(st._nll.growth, 1.1) and st._nll.lo == 1e-4
