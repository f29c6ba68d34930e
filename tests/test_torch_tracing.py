"""The port's ``utils/tracing.py`` against the JAX package's.

* TRACER: the same call sequence on the same injected clock (tracks,
  begin/end, complete, instants, deduplicated counters, annotate with
  re-parenting and links, a lexical span, a span left open, non-finite
  args) gives the same ``to_doc()`` JSON, the same ``summary()``,
  ``events()`` and ``trace_events()``, and the same sampled export.
* VALIDATION: ``validate_trace`` accepts both exports of closed buffers
  and rejects an unclosed span and a bare NaN token, on both sides alike.
* DISTRIBUTED LAYER: ``TraceContext.parse_traceparent`` and
  ``TraceSampler`` decide as JAX's do on the same strings and ids;
  ``merge_traces`` and ``trace_forest`` give JAX's documents.
* BUILD ACCOUNTING: ``CompileTracker`` counts ``data/native.py``'s g++
  build and its load at the site active at the time (the port's tracker
  counts builds and loads, not XLA programs) and mirrors them onto a bound
  tracer.
"""

import json

import numpy as np
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.utils import tracing as jtr
from distributed_tensorflow_ibm_mnist_tpu_torch.data import native
from distributed_tensorflow_ibm_mnist_tpu_torch.utils import tracing as ttr

torch.set_num_threads(1)


class _Clock:
    """A deterministic monotonic clock: each read advances 1.25 ms."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.00125
        return self.t


def _drive(mod, close_all=True):
    """One fixed call sequence through ``mod.Tracer``; returns it and the
    trace id it stamped."""
    tr = mod.Tracer(capacity=64, clock=_Clock())
    tid = tr.track("req 0")
    root = tr.begin("request", cat="serving", tid=tid, req=0, bucket=8)
    with tr.span("queue", cat="serving", parent=root, tid=tid) as q:
        tr.instant("enqueued", cat="serving", parent=q, tid=tid, depth=3)
    ph = tr.begin("decode", cat="serving", parent=root, tid=tid, slot=1)
    t0 = tr.clock()
    win = tr.complete("window", t0, t0 + 0.004, cat="serving", k=4, occupied=2)
    tr.complete("dispatch", t0, t0 + 0.001, cat="serving", parent=win)
    for v in (1, 1, 2, 2, 3.5):
        tr.counter("queue_depth", v)
    tr.counter("occupied_slots", 2, tid=tid)
    other = tr.begin("daemon_request", cat="daemon", trace="ab" * 16, sampled=True)
    assert tr.annotate(root, parent=other, links=[win], trace="ab" * 16, attempt=1)
    assert not tr.annotate(10_000, trace="x")  # unknown id: a no-op
    tr.instant("chaos_fault", parent=root, tid=tid, error=float("nan"))
    tr.end(ph)
    tr.end(ph)  # a double end is ignored
    tr.end(root, status="done", latency=float("inf"))
    lost = tr.begin("lost", cat="serving", tid=tid, trace="cd" * 16)
    tr.instant("shed", parent=lost)
    if close_all:
        tr.end(lost, status="failed")
        tr.end(other, status="done")
    return tr


def _json(doc) -> str:
    return json.dumps(doc, sort_keys=True, allow_nan=False)


@pytest.mark.parametrize("close_all", [True, False], ids=["closed", "open"])
def test_tracer_documents_equal_jax_on_the_same_clock(close_all):
    got, want = _drive(ttr, close_all), _drive(jtr, close_all)
    assert _json(got.to_doc()) == _json(want.to_doc())
    assert got.summary() == want.summary()
    assert repr(got.events()) == repr(want.events())  # NaN args compare by repr
    assert got.open_spans == want.open_spans == (0 if close_all else 2)
    for trace in ("ab" * 16, "cd" * 16):
        assert _json(got.trace_events(trace)) == _json(want.trace_events(trace))
    for rate in (0.0, 1.0):
        assert (_json(got.to_doc(sampler=ttr.TraceSampler(rate)))
                == _json(want.to_doc(sampler=jtr.TraceSampler(rate))))


def test_ring_eviction_drops_dangling_parents_as_jax_does():
    def drive(mod):
        tr = mod.Tracer(capacity=3, clock=_Clock())
        a = tr.begin("a")
        b = tr.begin("b", parent=a)
        tr.end(a)
        for i in range(4):
            tr.instant(f"i{i}", parent=b)
        tr.end(b)
        return tr
    got, want = drive(ttr), drive(jtr)
    assert got.dropped == want.dropped == 3
    assert _json(got.to_doc()) == _json(want.to_doc())


def test_validate_trace_accepts_both_exports_and_rejects_an_unclosed_span(tmp_path):
    for close_all in (True, False):
        paths = {}
        for name, mod in (("torch", ttr), ("jax", jtr)):
            paths[name] = str(tmp_path / f"{name}-{close_all}.json")
            info = _drive(mod, close_all).export_trace(paths[name])
            assert info["path"] == paths[name]
        got = ttr.validate_trace(paths["torch"])
        assert got == jtr.validate_trace(paths["torch"]) == jtr.validate_trace(paths["jax"])
        if close_all:
            assert got == []
        else:
            assert any("unclosed span" in p for p in got)
    bad = tmp_path / "nan.json"
    bad.write_text('{"traceEvents": [{"ph": "i", "ts": NaN}]}')
    assert ttr.validate_trace(str(bad)) == jtr.validate_trace(str(bad))
    assert ttr.validate_trace(str(bad))[0].startswith("unparseable")


HEADERS = [
    None, "", "garbage",
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 16 + "-00",
    " 00-" + "0af7651916cd43dd8448eb211c80319c" + "-" + "b7ad6b7169203331" + "-03 ",
    "00-" + "A" * 32 + "-" + "b" * 16 + "-01",       # uppercase
    "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",       # forbidden version
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01-x",     # 00 with an extra field
    "01-" + "a" * 32 + "-" + "b" * 16 + "-01-x",     # a later version: extras ok
    "00-" + "0" * 32 + "-" + "b" * 16 + "-01",       # zero trace id
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",       # zero span id
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",       # short trace id
    "00-" + "a" * 32 + "-" + "b" * 16 + "-1",        # short flags
    "00-" + "a" * 32 + "-" + "b" * 16 + "-zz",       # non-hex flags
    "0-" + "a" * 32 + "-" + "b" * 16 + "-01",        # short version
]


def _ctx(c):
    return None if c is None else (c.trace_id, c.span_id, c.sampled, c.to_traceparent())


@pytest.mark.parametrize("header", HEADERS)
def test_parse_traceparent_matches_jax(header):
    assert _ctx(ttr.TraceContext.parse_traceparent(header)) == _ctx(
        jtr.TraceContext.parse_traceparent(header))


def test_trace_context_identity_child_and_refusals():
    c = ttr.TraceContext("a" * 32, "b" * 16, sampled=False)
    j = jtr.TraceContext("a" * 32, "b" * 16, sampled=False)
    assert repr(c) == repr(j) and c.to_traceparent() == j.to_traceparent()
    kid = c.child()
    assert kid.trace_id == c.trace_id and kid.span_id != c.span_id
    assert kid.sampled is False and kid != c
    assert c == ttr.TraceContext("a" * 32, "b" * 16, False) and hash(c) == hash(
        ttr.TraceContext("a" * 32, "b" * 16, False))
    minted = ttr.TraceContext.mint()
    assert ttr.TraceContext.parse_traceparent(minted.to_traceparent()) == minted
    for args in (("0" * 32, "b" * 16), ("a" * 32, "0" * 16), ("a" * 30, "b" * 16)):
        with pytest.raises(ValueError):
            ttr.TraceContext(*args)


def test_trace_sampler_head_and_tail_match_jax():
    rng = np.random.default_rng(3)
    ids = ["".join(rng.choice(list("0123456789abcdef"), 32)) for _ in range(200)]
    for rate in (0.0, 0.05, 0.3, 0.9, 1.0):
        got, want = ttr.TraceSampler(rate), jtr.TraceSampler(rate)
        assert [got.head(t) for t in ids] == [want.head(t) for t in ids]
    groups = [
        [{"name": "request", "args": {"sampled": False}}],
        [{"name": "request", "args": {"sampled": True}}],
        [{"name": "shed", "args": {}}],
        [{"name": "request", "args": {"status": "failed"}}],
        [{"name": "request", "args": {"status": "done", "slo_miss": True}}],
        [{"name": "request", "args": {"error": "boom"}}],
        [{"name": "request", "args": None}],
    ]
    for rate in (0.0, 1.0):
        got, want = ttr.TraceSampler(rate), jtr.TraceSampler(rate)
        assert [got.keep(g) for g in groups] == [want.keep(g) for g in groups]
        assert [got.tail_keep(g) for g in groups] == [want.tail_keep(g) for g in groups]
    with pytest.raises(ValueError):
        ttr.TraceSampler(1.5)


def _distributed(mod, clock_seed):
    """Two 'processes' of one request: a front span and a downstream one
    joined by hex span_ctx/parent_ctx edges, plus a lost-parent pair."""
    front, back = mod.Tracer(clock=_Clock()), mod.Tracer(clock=_Clock())
    t = "1f" * 16
    h = front.begin("http_request", cat="front", trace=t, span_ctx="a1" * 8, sampled=True)
    front.end(h, status="done")
    d = back.begin("daemon_request", cat="daemon", trace=t, parent_ctx="a1" * 8,
                   span_ctx="b2" * 8)
    r = back.begin("request", parent=d)
    x = back.instant("replay", parent=r)
    back.annotate(r, links=[d])
    back.end(r)
    back.end(d, status="done")
    for gen in range(2):  # two process generations hanging off a lost parent
        s = back.begin("daemon_request", trace="2e" * 16, parent_ctx="cc" * 8)
        back.end(s, status="failed" if gen == 0 else "done")
    return front, back, x


def test_merge_traces_and_trace_forest_match_jax(tmp_path):
    fg, bg, _ = _distributed(ttr, 0)
    fj, bj, _ = _distributed(jtr, 0)
    got = ttr.merge_traces([fg, bg.to_doc()], names=["front", "back"])
    want = jtr.merge_traces([fj, bj.to_doc()], names=["front", "back"])
    assert _json(got) == _json(want)
    forest = ttr.trace_forest(got)
    assert forest == jtr.trace_forest(want)
    assert forest["1f" * 16]["connected"] and forest["1f" * 16]["roots"] == ["http_request"]
    assert forest["2e" * 16]["connected"]  # siblings of one lost parent
    # a file source and unnamed sources, written out
    path = tmp_path / "front.json"
    fg.export_trace(str(path))
    out = tmp_path / "merged.json"
    got = ttr.merge_traces([str(path), bg], path_or_file=str(out))
    assert _json(got) == _json(jtr.merge_traces([str(path), bj]))
    assert ttr.validate_trace(str(out)) == []


def test_compile_tracker_counts_the_native_build_at_its_site(tmp_path, monkeypatch):
    tracker = ttr.CompileTracker.install()
    assert ttr.CompileTracker.install() is tracker and tracker.mode == "builds"
    tracer = ttr.Tracer()
    prior = tracker._tracer
    tracker.bind(tracer)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "host")
    native.load.cache_clear()  # force a fresh g++ build and load here
    try:
        before = tracker.snapshot()
        with ttr.compile_site("outer"), tracker.site("native"):
            native.load()
        native.load()  # cached: neither a build nor a load
        delta = ttr.CompileTracker.delta(tracker.snapshot(), before)
    finally:
        tracker.bind(prior)
        native.load.cache_clear()  # later callers load from the real directory
    assert delta["n_compiled_programs"] == 1 and delta["n_loads"] == 1
    assert list(delta["by_site"]) == ["native"]  # the innermost site wins
    assert delta["by_site"]["native"]["n"] == 1 and delta["by_site"]["native"]["loads"] == 1
    assert delta["compile_time_s"] > 0
    assert list((tmp_path / "host").glob("libdtm-*.so"))
    names = [(e["name"], e["args"]["site"], e["args"]["library"])
             for e in tracer.events() if e["type"] == "instant"]
    assert names == [("library_build", "native", "dtm"), ("library_load", "native", "dtm")]
    # outside every site: unattributed; an unknown kind is refused
    before = tracker.snapshot()
    ttr.record_build("load", "probe", 0.0)
    assert list(ttr.CompileTracker.delta(tracker.snapshot(), before)["by_site"]) == [
        "unattributed"]
    with pytest.raises(ValueError, match="build"):
        ttr.record_build("compile", "probe", 0.0)
