"""The port's write-ahead request journal (``serving/journal.py``) and crash
recovery against the JAX package's, on the CPU.

* THE RECORDS ARE JAX'S: the same appends on one clock (``time.time``
  pinned) write byte-identical segment files in both packages, through
  rotation; JAX's scanner reads the port's journal and the port's reads
  JAX's, to equal ``JournalScan``s; ``_encode``/``_decode`` agree.
* TORN-TAIL TOLERANCE, on the same damaged directories in both packages
  (a truncated tail, a flipped byte mid-segment, an empty segment and a
  gap, seeded fuzz, orphans): the same scan, exactly.
* CHAOS: the ``journal-write`` site's torn, corrupt and io kinds; an io
  fault fails the submit (no ack without the WAL), the tier serves on.
* RECOVERY: a journaled daemon's clean run leaves nothing incomplete;
  ``recover`` replays from scratch and past a delivered high-water to
  streams token-identical to JAX's engine on the same converted weights
  (greedy and seeded), re-binds idempotency keys, retires a lapsed
  deadline ``cancelled``; a torn tail drops exactly one record and the
  reopened request replays to done.
* SIGKILL: a child process (``tests/torch_serve_child.py``: journal, front
  door, fsync'd telemetry) is killed while keyed SSE clients stream; the
  parent recovers from the journal alone; each client retries with its
  ``Idempotency-Key`` and ``Last-Event-ID``; every stitched transcript is
  gap-free, duplicate-consistent and equal to JAX's stream; a retried
  unary call binds to the replay without executing again.
"""

import dataclasses
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_serve_child
from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.serving import FIFOScheduler as JaxScheduler
from distributed_tensorflow_ibm_mnist_tpu.serving import InferenceEngine as JaxEngine
from distributed_tensorflow_ibm_mnist_tpu.serving import SamplingParams as JaxSampling
from distributed_tensorflow_ibm_mnist_tpu.serving import journal as jj
from distributed_tensorflow_ibm_mnist_tpu.serving.daemon import DaemonRequest as JaxDR
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import causal_lm_state_dict
from distributed_tensorflow_ibm_mnist_tpu_torch.models import CausalLM
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import (
    FIFOScheduler,
    FrontDoor,
    FrontDoorClient,
    InferenceEngine,
    JournalWriteError,
    RequestJournal,
    Router,
    SamplingParams,
    ServingDaemon,
    recover,
    scan_journal,
    transcript_digest,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import journal as tj
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.daemon import DaemonRequest
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.chaos import (
    FaultInjector,
    FaultPlan,
    FaultSpec,
)

torch.set_num_threads(1)

KW = dict(num_classes=16, dim=32, depth=1, heads=2)
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
SP = dict(temperature=0.8, top_k=8, seed=7)
WAIT_S = 60.0
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def weights():
    """Converted JAX weights and JAX's engine streams: greedy and seeded
    for PROMPTS (6 tokens), and 12 tokens a prompt for the SIGKILL test."""
    jm = jax_get_model("causal_lm", **KW, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    sd = causal_lm_state_dict(jax.tree.map(np.asarray, params), KW)

    def run(prompts, max_new, sampling=None):
        eng = JaxEngine(jm, params, slots=2, max_len=32,
                        scheduler=JaxScheduler(max_len=32, buckets=(8,)))
        reqs = [eng.submit(p, max_new=max_new, sampling=sampling(i) if sampling else None)
                for i, p in enumerate(prompts)]
        eng.run()
        eng.close()
        return [list(r.generated) for r in reqs]

    return {"sd": sd, "greedy": run(PROMPTS, 6),
            "seeded": run(PROMPTS, 6, lambda i: JaxSampling(**SP)),
            "crash": run(CRASH_PROMPTS, CRASH_NEW, lambda i: (
                JaxSampling(**CRASH_SP[i]) if i in CRASH_SP else None))}


def _factory(sd):
    def make_engine(tid):
        return InferenceEngine(
            CausalLM(device="cpu", dtype=torch.float32, **KW), sd, slots=2, max_len=32,
            scheduler=FIFOScheduler(max_len=32, buckets=(8,), max_queue=16),
            trace_tid=tid, device="cpu")
    return make_engine


def _fake_dr(cls, rid, prompt=(1, 2, 3), max_new=4, **kw):
    """A DaemonRequest the journal can serialize without a live tier."""
    dr = cls(rid, list(prompt), max_new, deadline_s=kw.pop("deadline_s", 30.0),
             submit_t=0.0, callback=None, **kw)
    dr.fingerprint = "00" * 8
    return dr


def _scan(scan) -> dict:
    d = dataclasses.asdict(scan)
    d.pop("directory")
    return d


@pytest.fixture
def fixed_wall(monkeypatch):
    """One wall clock for both journals' ``admitted`` records."""
    monkeypatch.setattr(time, "time", lambda: 1234.5)


def _write_both(tmp_path, ops, **kw):
    """Run ``ops(journal, DaemonRequest class)`` through each package's
    journal; return the two directories."""
    dirs = []
    for name, mod, cls in (("port", tj, DaemonRequest), ("jax", jj, JaxDR)):
        d = str(tmp_path / name)
        j = mod.RequestJournal(d, **kw)
        ops(j, cls)
        j.close()
        dirs.append(d)
    return dirs


def _segments(d) -> list:
    return [(n, open(os.path.join(d, n), "rb").read()) for n in sorted(os.listdir(d))]


# ------------------------------------------------------------- records


def test_records_and_rotation_are_byte_identical_to_jax(tmp_path, fixed_wall):
    def ops(j, cls):
        for i in range(4):
            j.admitted(_fake_dr(cls, i, sampling=None, idempotency_key=f"k{i}"))
        j.delivered(0, 2)
        j.delivered(0, 3)
        j.retired(0, "done", None)
        j.retired(1, "failed", "boom")

    port, ref = _write_both(tmp_path, ops, fsync_policy="never", segment_bytes=200)
    assert _segments(port) == _segments(ref) and len(_segments(port)) >= 3
    scans = [tj.scan_journal(port), jj.scan_journal(port), tj.scan_journal(ref)]
    assert _scan(scans[0]) == _scan(scans[1]) == _scan(scans[2])
    scan = scans[0]
    assert scan.records == 8 and scan.records_dropped == 0 and not scan.torn_tail
    assert scan.requests[0]["delivered"] == 3 and scan.requests[0]["retired"] == "done"
    assert [s["meta"]["id"] for s in scan.incomplete()] == [2, 3]
    assert scan.report() == jj.scan_journal(ref).report()
    # a second writer over the directory never reopens a segment
    with RequestJournal(port, fsync_policy="never") as j2:
        j2.retired(2, "cancelled", None)
    assert len(scan_journal(port).segments) == len(scan.segments) + 1
    rec = {"t": "delivered", "id": 3, "n": 11}
    assert tj._encode(rec) == jj._encode(rec)
    assert tj._decode(tj._encode(rec)[:-1]) == rec
    for raw in (b"", b"deadbeef {not json}", bytes(bytearray(tj._encode(rec)[:-1])[:12])):
        assert tj._decode(raw) is None and jj._decode(raw) is None


def test_sampled_identity_and_traceparent_round_trip(tmp_path, fixed_wall):
    from distributed_tensorflow_ibm_mnist_tpu.utils.tracing import TraceContext as JCtx
    from distributed_tensorflow_ibm_mnist_tpu_torch.utils.tracing import TraceContext

    tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"

    def ops(j, cls):
        samp = (SamplingParams if cls is DaemonRequest else JaxSampling)(**SP)
        ctx = (TraceContext if cls is DaemonRequest else JCtx).parse_traceparent(tp)
        j.admitted(_fake_dr(cls, 5, sampling=samp, resume_from=2, trace_ctx=ctx,
                            idempotency_key="key"))

    port, ref = _write_both(tmp_path, ops, fsync_policy="always")
    assert _segments(port) == _segments(ref)
    meta = scan_journal(port).requests[5]["meta"]
    assert meta["tp"] == tp and meta["resume_from"] == 2 and meta["key"] == "key"
    assert SamplingParams.from_dict(meta["sampling"]) == SamplingParams(**SP)


def test_fsync_policies_and_refusals(tmp_path):
    for bad in (dict(fsync_policy="sometimes"), dict(fsync_interval_s=0),
                dict(segment_bytes=0)):
        with pytest.raises(ValueError):
            RequestJournal(str(tmp_path / "x"), **bad)
    ja = RequestJournal(str(tmp_path / "a"), fsync_policy="always")
    for i in range(5):
        ja.delivered(0, i)
    ja.close()
    assert ja.stats()["fsyncs"] >= 5
    jn = RequestJournal(str(tmp_path / "n"), fsync_policy="never")
    for i in range(5):
        jn.delivered(0, i)
    jn.close()
    assert jn.stats()["fsyncs"] == 1  # close() always syncs
    jn.close()
    with pytest.raises(JournalWriteError):
        jn.delivered(0, 9)
    ji = RequestJournal(str(tmp_path / "i"), fsync_policy="interval", fsync_interval_s=0.01)
    ji.delivered(0, 1)
    deadline = time.monotonic() + WAIT_S
    while ji.stats()["fsyncs"] == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert ji.stats()["fsyncs"] >= 1  # the background syncer
    ji.close()


# ------------------------------------------------------- damaged journals


def _write_clean(d, mod=tj, cls=DaemonRequest, n_requests=6, segment_bytes=300):
    j = mod.RequestJournal(d, fsync_policy="never", segment_bytes=segment_bytes)
    for i in range(n_requests):
        j.admitted(_fake_dr(cls, i))
        j.delivered(i, 2)
    j.retired(0, "done", None)
    j.close()
    return j.stats()["records"]


def _same_scan(d):
    a, b = tj.scan_journal(d), jj.scan_journal(d)
    assert _scan(a) == _scan(b)
    return a


def test_damage_scans_equal_jax(tmp_path, fixed_wall):
    d = str(tmp_path / "torn")
    total = _write_clean(d)
    segs = sorted(f for f in os.listdir(d) if f.startswith("journal-"))
    path = os.path.join(d, segs[-1])
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:-9])   # mid-record, the newline gone
    scan = _same_scan(d)
    assert scan.torn_tail and scan.records_dropped == 1 and scan.records == total - 1

    d = str(tmp_path / "flip")
    total = _write_clean(d)
    path = os.path.join(d, sorted(os.listdir(d))[0])
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0x40
    open(path, "wb").write(bytes(raw))
    scan = _same_scan(d)
    assert scan.records_dropped >= 1 and not scan.torn_tail
    assert scan.records + scan.records_dropped == total

    d = str(tmp_path / "gap")
    total = _write_clean(d)
    segs = sorted(os.listdir(d))
    open(os.path.join(d, tj._segment_name(99)), "wb").close()
    lost = open(os.path.join(d, segs[1]), "rb").read().count(b"\n")
    os.remove(os.path.join(d, segs[1]))
    scan = _same_scan(d)
    assert segs[1] in scan.segment_gaps and scan.records == total - lost
    assert not scan.torn_tail and scan_journal(str(tmp_path / "none")).records == 0

    d = str(tmp_path / "orphan")
    j = RequestJournal(d, fsync_policy="never")
    j.delivered(7, 3)
    j.retired(7, "done", None)
    j.close()
    scan = _same_scan(d)
    assert scan.orphan_records == 2 and scan.requests == {} and scan.incomplete() == []


def test_corruption_fuzz_scans_equal_jax(tmp_path, fixed_wall):
    rng = random.Random(1234)
    for trial in range(8):
        d = str(tmp_path / f"j{trial}")
        total = _write_clean(d, n_requests=8, segment_bytes=250)
        scannable = 0
        for name in sorted(os.listdir(d)):
            path = os.path.join(d, name)
            raw = bytearray(open(path, "rb").read())
            op = rng.random()
            if raw and op < 0.4:
                raw[rng.randrange(len(raw))] ^= 1 << rng.randrange(8)
            elif raw and op < 0.7:
                del raw[rng.randrange(len(raw)):]
            open(path, "wb").write(bytes(raw))
            lines = bytes(raw).split(b"\n")
            if lines and lines[-1] == b"":
                lines.pop()
            scannable += len(lines)
        scan = _same_scan(d)
        assert scan.records + scan.records_dropped == scannable and scan.records <= total


# ------------------------------------------------------------------ chaos


@pytest.mark.parametrize("kind,at,dropped,delivered", [
    ("torn", 2, 1, 3), ("corrupt", 1, 1, 3)])
def test_chaos_torn_and_corrupt_drop_exactly_that_record(tmp_path, kind, at, dropped,
                                                         delivered):
    d = str(tmp_path / "j")
    chaos = FaultInjector(FaultPlan(seed=0, faults=(
        FaultSpec(site="journal-write", kind=kind, at=(at,)),)))
    j = RequestJournal(d, fsync_policy="never", chaos=chaos)
    j.admitted(_fake_dr(DaemonRequest, 0))
    for n in (1, 2, 3):
        j.delivered(0, n)
    j.retired(0, "done", None)
    j.close()
    assert j.stats()[f"chaos_{kind}"] == 1
    scan = scan_journal(d)
    assert scan.records_dropped == dropped and not scan.torn_tail
    assert scan.requests[0]["delivered"] == delivered
    assert scan.requests[0]["retired"] == "done"


def test_chaos_io_fault_fails_the_submit(tmp_path, weights):
    d = str(tmp_path / "j")
    chaos = FaultInjector(FaultPlan(seed=0, faults=(
        FaultSpec(site="journal-write", kind="io", at=(0,)),)))
    daemon = ServingDaemon(Router(_factory(weights["sd"]), 1),
                           journal=RequestJournal(d, fsync_policy="never", chaos=chaos))
    with pytest.raises(JournalWriteError):
        daemon.submit([1, 2, 3], 4)
    assert daemon.conservation()["submitted"] == 0
    assert daemon.counters["journal_errors"] == 1
    dr = daemon.submit([1, 2, 3], 4)      # the next submit lands
    assert daemon.conservation()["submitted"] == 1
    daemon.close()
    assert scan_journal(d).requests[dr.id]["retired"] == "cancelled"


# --------------------------------------------------------------- recovery


def test_clean_run_leaves_nothing_incomplete(tmp_path, weights):
    d = str(tmp_path / "j")
    daemon = ServingDaemon(Router(_factory(weights["sd"]), 2),
                           journal=RequestJournal(d, fsync_policy="interval"))
    with daemon:
        drs = [daemon.submit(p, 6) for p in PROMPTS]
        assert all(dr.wait(WAIT_S) for dr in drs)
        assert [dr.tokens for dr in drs] == weights["greedy"]
        assert daemon.summary()["journal"]["by_type"]["admitted"] == len(PROMPTS)
    scan = scan_journal(d)
    assert scan.incomplete() == []
    for dr in drs:
        assert scan.requests[dr.id] == {"meta": scan.requests[dr.id]["meta"],
                                        "delivered": len(dr.tokens), "retired": "done"}


def _recovered(d, sd, replicas=1):
    return recover(d, lambda: ServingDaemon(Router(_factory(sd), replicas),
                                            journal=RequestJournal(d)))


def test_recover_replays_from_scratch_and_rebinds_keys(tmp_path, weights):
    d = str(tmp_path / "j")
    crashed = ServingDaemon(Router(_factory(weights["sd"]), 1), journal=RequestJournal(d))
    for p in PROMPTS:
        crashed.submit(p, 6, idempotency_key=f"key-{len(p)}")
    for p in PROMPTS:
        crashed.submit(p, 6, sampling=SamplingParams(**SP))
    crashed._journal.sync()     # never started: admitted records only
    rec = _recovered(d, weights["sd"], 2)
    try:
        assert rec.scan.report()["incomplete"] == 2 * len(PROMPTS)
        assert rec.wait(WAIT_S)
        got = [r.dr.tokens for r in rec.requests]
        assert got == weights["greedy"] + weights["seeded"]
        assert set(rec.bindings) == {f"key-{len(p)}" for p in PROMPTS}
        assert rec.report()["replayed"] == 2 * len(PROMPTS)
    finally:
        rec.daemon.close()
    scan = scan_journal(d)
    crashed_ids, replay_ids = {r.orig_id for r in rec.requests}, {r.dr.id for r in rec.requests}
    assert crashed_ids.isdisjoint(replay_ids)
    assert all(scan.requests[i]["retired"] == "replayed" for i in crashed_ids)
    assert all(scan.requests[i]["retired"] == "done" for i in replay_ids)
    assert scan.report()["incomplete"] == 0
    crashed.close()


def test_recover_resumes_past_the_high_water(tmp_path, weights):
    want = weights["seeded"][0]
    d = str(tmp_path / "j")
    j = RequestJournal(d)
    j.admitted(_fake_dr(DaemonRequest, 0, prompt=PROMPTS[0], max_new=6,
                        sampling=SamplingParams(**SP), idempotency_key="resume-me"))
    j.delivered(0, 2)
    j.delivered(0, 4)   # the high-water is the max
    j.close()
    rec = _recovered(d, weights["sd"])
    try:
        assert rec.wait(WAIT_S)
        (r,) = rec.requests
        assert r.orig_id == 0 and r.resume_from == 4 == r.dr.resume_from
        assert r.dr.tokens == want[4:] and r.dr.total_tokens == len(want)
        assert transcript_digest(want[:4] + r.dr.tokens) == transcript_digest(want)
        assert rec.bindings["resume-me"] is r.dr
    finally:
        rec.daemon.close()


def test_recover_lapsed_deadline_and_torn_tail(tmp_path, weights):
    d = str(tmp_path / "lapsed")
    j = RequestJournal(d)
    j.append({"t": "admitted", "id": 0, "prompt": [1, 2, 3], "max_new": 6,
              "deadline_s": 0.5, "priority": 0, "ttft_slo_s": None, "tpot_slo_s": None,
              "sampling": None, "key": None, "fp": "00" * 8, "resume_from": 0,
              "wall_t": 1.0})  # admitted "long ago"
    j.close()
    rec = _recovered(d, weights["sd"])
    try:
        assert rec.wait(WAIT_S)
        (r,) = rec.requests
        assert r.dr.status == "cancelled"
    finally:
        rec.daemon.close()
    assert rec.daemon.conservation()["conserved"]
    assert scan_journal(d).requests[r.dr.id]["retired"] == "cancelled"
    # the torn tail: the retired record of a served request is torn
    d = str(tmp_path / "torn")
    torn = FaultInjector(FaultPlan(seed=0, faults=(
        FaultSpec(site="journal-write", kind="torn", at=(2,)),)))
    daemon = ServingDaemon(Router(_factory(weights["sd"]), 1),
                           journal=RequestJournal(d, fsync_policy="always", chaos=torn),
                           journal_hw_interval_s=1e9)   # admitted, final mark, retired
    with daemon:
        dr = daemon.submit(PROMPTS[2], 6)
        assert dr.wait(WAIT_S) and dr.status == "done"
    scan = scan_journal(d)
    assert scan.records_dropped == 1 and scan.torn_tail and len(scan.incomplete()) == 1
    assert _scan(scan) == _scan(jj.scan_journal(d))
    rec = _recovered(d, weights["sd"])
    try:
        assert rec.wait(WAIT_S)
        (r,) = rec.requests
        assert r.dr.status == "done" and r.resume_from == 6 and r.dr.tokens == []
        assert r.dr.total_tokens == len(weights["greedy"][2])
    finally:
        rec.daemon.close()


# ---------------------------------------------------------------- SIGKILL

CRASH_PROMPTS = [[1, 2, 3, 4], [5, 6, 7], [8, 9, 10, 11, 12]]
CRASH_SP = {1: dict(temperature=0.9, top_p=0.9, seed=21)}
CRASH_NEW = 12


def test_sigkill_mid_stream_recovers_exactly_once(tmp_path, weights):
    work = tmp_path / "crash"
    work.mkdir()
    torch.save(weights["sd"], work / "weights.pt")
    cfg = {"model": KW, "engine": {"slots": 2, "max_len": 32}, "max_len": 32,
           "buckets": [8], "replicas": 1, "step_sleep_s": 0.05}
    (work / "config.json").write_text(json.dumps(cfg))
    err = open(work / "child.err", "w")
    child = subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_serve_child.py"), str(work)],
        cwd=str(REPO), env={**os.environ, "PYTHONPATH": str(REPO)},
        stdout=subprocess.DEVNULL, stderr=err)
    results: dict = {}
    lock = threading.Lock()
    unary: dict = {}
    try:
        deadline = time.monotonic() + WAIT_S
        while not (work / "port").exists():
            assert child.poll() is None, (work / "child.err").read_text()[-2000:]
            assert time.monotonic() < deadline, "the serving child did not start"
            time.sleep(0.02)
        port = int((work / "port").read_text())

        def client(i):
            c = FrontDoorClient("127.0.0.1", port, timeout=WAIT_S)
            rec = {"pairs": [], "terminal": None, "last_event_id": None}
            with lock:
                results[i] = rec
            kw = {"sampling": CRASH_SP[i]} if i in CRASH_SP else {}
            try:
                for tok in c.stream(CRASH_PROMPTS[i], CRASH_NEW, idempotency_key=f"c-{i}",
                                    deadline_s=WAIT_S, **kw):
                    with lock:
                        rec["pairs"].append((c.last_event_id, tok))
                        rec["last_event_id"] = c.last_event_id
            except Exception:  # the kill severs the socket mid-read
                pass
            rec["terminal"] = c.last_terminal

        def unary_client():
            c = FrontDoorClient("127.0.0.1", port, timeout=WAIT_S)
            try:
                unary["body"] = c.generate([3, 1, 4], CRASH_NEW, idempotency_key="u-1")
            except Exception:
                pass

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(CRASH_PROMPTS))] + [threading.Thread(target=unary_client)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            with lock:
                seen = sum(len(r["pairs"]) for r in results.values())
            if seen >= 2 and any(v["retired"] is None for v in
                                 scan_journal(str(work / "journal")).requests.values()):
                break
            time.sleep(0.005)
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=WAIT_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=WAIT_S)
        err.close()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads)
    jdir = str(work / "journal")
    assert sum(1 for _ in open(work / "telemetry.jsonl")) >= 1   # fsync'd black box
    rec = recover(jdir, lambda: torch_serve_child.build_daemon(
        work, cfg, RequestJournal(jdir, fsync_policy="always")), resubmit_timeout_s=WAIT_S)
    fd = FrontDoor(rec.daemon, idempotency_bindings=rec.bindings).start_in_thread()
    try:
        assert len(rec.requests) >= 1 and rec.wait(WAIT_S)
        for i, got in results.items():
            if got["terminal"] is not None and got["terminal"].get("status") == "done":
                continue
            c = FrontDoorClient("127.0.0.1", fd.port, timeout=WAIT_S)
            kw = {"sampling": CRASH_SP[i]} if i in CRASH_SP else {}
            for tok in c.stream(CRASH_PROMPTS[i], CRASH_NEW, idempotency_key=f"c-{i}",
                                last_event_id=got["last_event_id"], deadline_s=WAIT_S, **kw):
                got["pairs"].append((c.last_event_id, tok))
            got["terminal"] = c.last_terminal
        for i, want in enumerate(weights["crash"]):
            got = results[i]
            assert got["terminal"]["status"] == "done"
            stitched: dict = {}
            for eid, tok in got["pairs"]:
                assert stitched.get(eid, tok) == tok        # duplicates agree
                stitched[eid] = tok
            assert sorted(stitched) == list(range(CRASH_NEW))  # no gap
            assert transcript_digest([stitched[k] for k in range(CRASH_NEW)]) == \
                transcript_digest(want)                        # JAX's stream
        submitted, hits = rec.daemon.counters["submitted"], fd.counters["idempotent_hits"]
        c = FrontDoorClient("127.0.0.1", fd.port, timeout=WAIT_S)
        body = c.generate([3, 1, 4], CRASH_NEW, idempotency_key="u-1")
        assert c.last_status == 200 and body["status"] == "done"
        if "u-1" in rec.bindings:       # journaled before the kill: it binds
            assert rec.daemon.counters["submitted"] == submitted
            assert fd.counters["idempotent_hits"] == hits + 1
    finally:
        fd.stop()
        rec.daemon.close()
