"""The port's front door (``serving/frontend.py``) and request cancellation
against the JAX package's, on the CPU.

* THE WIRE IS JAX'S: the same requests, on the same converted weights,
  sent as raw HTTP to a JAX tier's ``FrontDoor`` and to the port's, get
  byte-identical responses — status lines, headers (the ``traceparent``
  value, random per request, aside) and bodies: unary JSON, the SSE
  stream (one ``id: n`` + ``data: {"token": t}`` a token, a terminal
  ``event: end``), 400/404/405/422 and a 503 after the drain.
  ``_parse_generate`` and ``_sanitize_request_id`` decide as JAX's do.
* PARITY: unary, SSE and ``daemon.stream`` give identical tokens, greedy
  and seeded-sampled, equal to JAX's engine.
* DISCONNECT CANCELS (an unkeyed stream): slot and pages freed, 0 open
  spans, conservation exact; a keyed one survives and resumes with
  ``Last-Event-ID`` exactly the missing suffix; a retried unary call with
  the same key binds without executing again; a reused key with another
  body gets 422.
* BACKPRESSURE: 429 with an integer ``Retry-After`` from the policy's
  predictor; 503 draining; 503 over connection capacity; 408 for a slow
  client; keep-alive pings on a stalled stream.
* OBSERVABILITY: ``/healthz`` census and degradation, one ``/metrics``
  scrape with the front door's and the tier's counters, OpenMetrics
  exemplars, ``traceparent`` echo and join, the request trace endpoint,
  the shed span the tail sampler keeps.

Every wait carries a timeout; every tier is torn down in ``finally``.
"""

import json
import re
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.serving import FIFOScheduler as JaxScheduler
from distributed_tensorflow_ibm_mnist_tpu.serving import FrontDoor as JaxFrontDoor
from distributed_tensorflow_ibm_mnist_tpu.serving import InferenceEngine as JaxEngine
from distributed_tensorflow_ibm_mnist_tpu.serving import Router as JaxRouter
from distributed_tensorflow_ibm_mnist_tpu.serving import SamplingParams as JaxSampling
from distributed_tensorflow_ibm_mnist_tpu.serving import ServingDaemon as JaxDaemon
from distributed_tensorflow_ibm_mnist_tpu.serving import frontend as jfe
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import causal_lm_state_dict
from distributed_tensorflow_ibm_mnist_tpu_torch.models import CausalLM
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import (
    DeadlineAwarePolicy,
    FIFOScheduler,
    FrontDoor,
    FrontDoorClient,
    InferenceEngine,
    Router,
    SamplingParams,
    ServingDaemon,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import frontend as tfe
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.telemetry import (
    MetricsRegistry,
    Telemetry,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.tracing import (
    TraceContext,
    Tracer,
    TraceSampler,
    trace_forest,
)

torch.set_num_threads(1)

KW = dict(num_classes=16, dim=32, depth=1, heads=2)
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [2, 4, 6]]
SAMPLED = {"temperature": 0.7, "top_k": 5, "seed": 42}
WAIT_S = 60.0


@pytest.fixture(scope="module")
def weights():
    jm = jax_get_model("causal_lm", **KW, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    sd = causal_lm_state_dict(jax.tree.map(np.asarray, params), KW)
    return jm, params, sd


def _factory(sd, **kw):
    def make_engine(tid):
        return InferenceEngine(
            CausalLM(device="cpu", dtype=torch.float32, **KW), sd, slots=2, max_len=16,
            kv_page_size=4, scheduler=FIFOScheduler(max_len=16, buckets=(8,), max_queue=16),
            trace_tid=tid, device="cpu", **kw)
    return make_engine


def _jax_factory(jm, params):
    def make_engine(tid):
        return JaxEngine(jm, params, slots=2, max_len=16, kv_page_size=4,
                         scheduler=JaxScheduler(max_len=16, buckets=(8,), max_queue=16),
                         trace_tid=tid)
    return make_engine


def _pools_refcount_zero(router) -> bool:
    for rep in router.replicas:
        if not rep.alive or rep.engine._pool is None:
            continue
        eng, stack = rep.engine, [rep.engine._radix.root]
        while stack:
            node = stack.pop()
            if node.ref != 0:
                return False
            stack.extend(node.children.values())
        if eng._pool.allocated != eng._radix.n_blocks:
            return False
    return True


def _wait_outstanding_zero(daemon) -> dict:
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        cons = daemon.conservation()
        if cons["outstanding"] == 0:
            return cons
        time.sleep(0.02)
    return daemon.conservation()


class _Tier:
    """A daemon + front door on an ephemeral port, torn down hard."""

    def __init__(self, router, fd_kw=None, **daemon_kw):
        self.router = router
        self.daemon = ServingDaemon(router, **{"max_queue": 32, **daemon_kw})
        self.fd = FrontDoor(self.daemon, **(fd_kw or {}))

    def __enter__(self):
        self.daemon.start()
        self.fd.start_in_thread()
        return self.daemon, self.fd

    def __exit__(self, *exc):
        self.fd.stop()
        if not self.daemon._closed:
            self.daemon.drain(timeout=WAIT_S)
            self.daemon.close()


@pytest.fixture()
def tier(weights):
    tracer = Tracer()
    router = Router(_factory(weights[2], tracer=tracer), 2, tracer=tracer)
    with _Tier(router) as (daemon, fd):
        yield daemon, fd, tracer


def _raw(port, method, path, body=None, headers=()) -> bytes:
    """One raw HTTP exchange; the whole response up to the server's close."""
    payload = b"" if body is None else json.dumps(body).encode()
    head = f"{method} {path} HTTP/1.1\r\nHost: t\r\n".encode()
    for h in headers:
        head += f"{h}\r\n".encode()
    if body is not None:
        head += (b"Content-Type: application/json\r\n"
                 + f"Content-Length: {len(payload)}\r\n".encode())
    sock = socket.create_connection(("127.0.0.1", port), timeout=WAIT_S)
    sock.sendall(head + b"\r\n" + payload)
    data = b""
    while True:
        chunk = sock.recv(65536)
        if not chunk:
            break
        data += chunk
    sock.close()
    return data


def _normalized(raw: bytes) -> bytes:
    """The response with the (random) traceparent value masked."""
    return re.sub(rb"traceparent: 00-[0-9a-f]{32}-[0-9a-f]{16}-0[01]",
                  b"traceparent: <masked>", raw)


# ---------------------------------------------------------- wire parity


EXCHANGES = [
    ("POST", "/v1/generate", {"prompt": [1, 2, 3], "max_new": 4}, ()),
    ("POST", "/v1/generate", {"prompt": [4, 5], "max_new": 4, "stream": True}, ()),
    ("POST", "/v1/generate", {"prompt": [6, 7, 8, 9], "max_new": 5, "stream": True,
                              "sampling": SAMPLED}, ("X-Request-Id: wire-1",)),
    ("POST", "/v1/generate", {"prompt": [2, 4], "max_new": 3},
     ("Idempotency-Key: k1",)),
    ("POST", "/v1/generate", {"prompt": [2, 4], "max_new": 3},
     ("Idempotency-Key: k1",)),                         # binds: no second run
    ("POST", "/v1/generate", {"prompt": [2, 4], "max_new": 3, "stream": True},
     ("Idempotency-Key: k1", "Last-Event-ID: 0")),      # resumes the suffix
    ("POST", "/v1/generate", {"prompt": [9, 9], "max_new": 3},
     ("Idempotency-Key: k1",)),                         # 422: another body
    ("POST", "/v1/generate", {"prompt": [], "max_new": 4}, ()),
    ("POST", "/v1/generate", {"prompt": [1], "max_new": 2, "sampling": {"beam": 3}}, ()),
    ("POST", "/v1/generate", {"prompt": [1, 2], "max_new": 2, "stream": True},
     ("Last-Event-ID: nope",)),
    ("GET", "/v1/generate", None, ()),
    ("POST", "/healthz", {}, ()),
    ("GET", "/v2/nothing", None, ()),
    ("GET", "/v1/requests/never-seen/trace", None, ()),
]


def test_wire_bytes_and_codes_equal_jax(weights):
    jm, params, sd = weights
    got = {}
    for side in ("jax", "port"):
        if side == "jax":
            daemon = JaxDaemon(JaxRouter(_jax_factory(jm, params), 1), max_queue=32)
            fd = JaxFrontDoor(daemon)
        else:
            daemon = ServingDaemon(Router(_factory(sd), 1), max_queue=32)
            fd = FrontDoor(daemon)
        daemon.start()
        fd.start_in_thread()
        try:
            got[side] = [_normalized(_raw(fd.port, *ex)) for ex in EXCHANGES]
            daemon.drain(timeout=WAIT_S)
            got[side].append(_normalized(_raw(fd.port, *EXCHANGES[0])))   # 503 draining
        finally:
            fd.stop()
            daemon.close()
    codes = [r.split(b"\r\n", 1)[0] for r in got["port"]]
    assert codes == [r.split(b"\r\n", 1)[0] for r in got["jax"]]
    assert [c.split(b" ")[1] for c in codes] == [
        b"200", b"200", b"200", b"200", b"200", b"200", b"422", b"400", b"400", b"400",
        b"405", b"405", b"404", b"503", b"503"]   # no tracer wired: the trace endpoint 503s
    for i, (a, b) in enumerate(zip(got["port"], got["jax"])):
        assert a == b, (i, a[-400:], b[-400:])
    sse = got["port"][1].split(b"\r\n\r\n", 1)[1]
    assert sse.startswith(b"id: 0\ndata: {\"token\": ") and b"event: end\n" in sse


def test_request_parsing_and_id_sanitizing_are_jaxs():
    good = [{"prompt": [1, 2], "max_new": 3},
            {"prompt": [1], "max_new": 1, "stream": True, "priority": 2, "deadline_s": 5,
             "ttft_slo_s": 0.5, "sampling": {"temperature": 0.5, "seed": 7}}]
    for body in good:
        a, b = tfe._parse_generate(body), jfe._parse_generate(body)
        assert {k: v for k, v in a.items() if k != "sampling"} == \
            {k: v for k, v in b.items() if k != "sampling"}
        assert (a["sampling"] is None) == (b["sampling"] is None)
        if a["sampling"] is not None:
            assert a["sampling"].to_dict() == b["sampling"].to_dict()
    for bad in ([], {"max_new": 2}, {"prompt": [], "max_new": 2}, {"prompt": [1.5], "max_new": 2},
                {"prompt": [True], "max_new": 2}, {"prompt": [1], "max_new": 0},
                {"prompt": [1], "max_new": 2, "deadline_s": -1},
                {"prompt": [1], "max_new": 2, "priority": "high"},
                {"prompt": [1], "max_new": 2, "sampling": {"beam": 4}},
                {"prompt": [1], "max_new": 2, "sampling": {"temperature": 0.0, "top_p": 0.5}}):
        with pytest.raises(ValueError) as a:
            tfe._parse_generate(bad)
        with pytest.raises(ValueError) as b:
            jfe._parse_generate(bad)
        assert str(a.value) == str(b.value)
    for raw in ("cli.id:ok-1", "not ok", "x" * 65, "x" * 64, "new\tline", "", None, 7):
        assert tfe._sanitize_request_id(raw) == jfe._sanitize_request_id(raw)


def test_transports_agree_and_equal_jax(weights, tier):
    jm, params, _ = weights
    daemon, fd, _ = tier
    cli = FrontDoorClient("127.0.0.1", fd.port)
    for sampling in (None, SAMPLED):
        jeng = JaxEngine(jm, params, slots=2, max_len=16, kv_page_size=4,
                         scheduler=JaxScheduler(max_len=16, buckets=(8,)))
        jreqs = [jeng.submit(p, max_new=4, sampling=None if sampling is None
                             else JaxSampling(**sampling)) for p in PROMPTS]
        jeng.run()
        jeng.close()
        for prompt, jr in zip(PROMPTS, jreqs):
            kw = {} if sampling is None else {"sampling": sampling}
            unary = cli.generate(prompt, 4, **kw)
            assert cli.last_status == 200, unary
            sse = list(cli.stream(prompt, 4, **kw))
            assert cli.last_terminal["status"] == "done"
            assert cli.last_terminal["n_tokens"] == len(sse) == 4
            dr = daemon.submit(prompt, 4, sampling=None if sampling is None
                               else SamplingParams(**sampling))
            assert unary["tokens"] == sse == list(daemon.stream(dr, timeout=WAIT_S)) \
                == list(jr.generated)
    # concurrent streams keep delivery order
    streams = {}

    def worker(i, prompt):
        c = FrontDoorClient("127.0.0.1", fd.port)
        streams[i] = (list(c.stream(prompt, 4)), c.last_terminal)

    threads = [threading.Thread(target=worker, args=(i, p)) for i, p in enumerate(PROMPTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    for i, prompt in enumerate(PROMPTS):
        toks, term = streams[i]
        assert term["status"] == "done"
        assert list(daemon.stream(daemon.submit(prompt, 4), timeout=WAIT_S)) == toks


# ------------------------------------------------------------ disconnect


def _post_stream(port, body: dict, extra=b"") -> socket.socket:
    payload = json.dumps({**body, "stream": True}).encode()
    sock = socket.create_connection(("127.0.0.1", port), timeout=WAIT_S)
    sock.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: t\r\nContent-Type: application/json\r\n"
                 + extra + f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    return sock


def test_disconnect_cancels_and_conserves(tier):
    daemon, fd, tracer = tier
    sock = _post_stream(fd.port, {"prompt": [5, 6, 7], "max_new": 6, "deadline_s": 60.0})
    sock.recv(64)
    sock.close()
    background = [daemon.submit(p, 6) for p in PROMPTS]
    sock = _post_stream(fd.port, {"prompt": [9, 9], "max_new": 4})
    sock.close()            # gone before reading a byte
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline and fd.counters["disconnects"] < 2:
        time.sleep(0.02)
    assert fd.counters["disconnects"] >= 2 and fd.counters["disconnect_cancels"] >= 1
    assert all(dr.wait(timeout=WAIT_S) and dr.status == "done" for dr in background)
    cons = _wait_outstanding_zero(daemon)
    assert cons["conserved"] and cons["outstanding"] == 0
    assert cons["cancelled"] >= 1 and cons["cancelled"] + cons["done"] == cons["submitted"]
    assert daemon.drain(timeout=WAIT_S)
    assert all(rep.engine.occupied == 0 for rep in daemon.router.replicas)
    assert _pools_refcount_zero(daemon.router) and tracer.open_spans == 0


def test_keyed_disconnect_survives_and_resumes(tier):
    daemon, fd, _ = tier
    sock = _post_stream(fd.port, {"prompt": list(PROMPTS[0]), "max_new": 6},
                        b"Idempotency-Key: sever\r\n")
    sock.recv(64)
    sock.close()
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline and fd.counters["disconnects"] < 1:
        time.sleep(0.02)
    cons = _wait_outstanding_zero(daemon)
    assert cons["done"] == cons["submitted"] == 1 and cons["cancelled"] == 0
    assert fd.counters["disconnect_cancels"] == 0
    cli = FrontDoorClient("127.0.0.1", fd.port)
    suffix = list(cli.stream(PROMPTS[0], 6, idempotency_key="sever", last_event_id=1))
    assert cli.last_terminal["status"] == "done" and cli.last_terminal["n_tokens"] == 6
    want = list(daemon.stream(daemon.submit(PROMPTS[0], 6), timeout=WAIT_S))
    assert suffix == want[2:] and cli.last_event_id == 5 and fd.counters["resumes"] == 1
    # the unary retry binds to the original; another body under the key: 422
    first = cli.generate(PROMPTS[1], 4, idempotency_key="once")
    submitted = daemon.counters["submitted"]
    retry = cli.generate(PROMPTS[1], 4, idempotency_key="once")
    assert retry["id"] == first["id"] and retry["tokens"] == first["tokens"]
    assert daemon.counters["submitted"] == submitted
    clash = cli.generate(PROMPTS[2], 4, idempotency_key="once")
    assert cli.last_status == 422 and clash["id"] == first["id"]
    assert daemon.conservation()["conserved"]


def test_daemon_cancel_queued_and_in_flight(weights):
    router = Router(_factory(weights[2]), 1)
    daemon = ServingDaemon(router, max_queue=32).start()
    try:
        first = daemon.submit([1, 2, 3], 6)
        victims = [daemon.submit(p, 6) for p in PROMPTS]
        assert daemon.cancel(victims[-1])
        assert victims[-1].wait(timeout=WAIT_S) and victims[-1].status == "cancelled"
        assert all(dr.wait(timeout=WAIT_S) and dr.status == "done"
                   for dr in [first] + victims[:-1])
        assert daemon.cancel(first) is False
        running = daemon.submit([4, 4, 4], 12)
        deadline = time.monotonic() + WAIT_S
        while not running.tokens and time.monotonic() < deadline:
            time.sleep(0.005)
        assert daemon.cancel(running)
        assert running.wait(timeout=WAIT_S) and running.status in ("cancelled", "done")
        cons = daemon.conservation()
        assert cons["conserved"] and cons["cancelled"] >= 1
        assert daemon.drain(timeout=WAIT_S) and _pools_refcount_zero(router)
    finally:
        daemon.close()


# ---------------------------------------------------------- backpressure


def test_429_retry_after_and_503s(weights):
    router = Router(_factory(weights[2]), 1)
    with _Tier(router, max_queue=2, policy=DeadlineAwarePolicy(concurrency=2)) as (daemon, fd):
        cli = FrontDoorClient("127.0.0.1", fd.port)
        assert cli.generate(PROMPTS[0], 4)["status"] == "done"   # warms the predictor
        results = []

        def flood(p):
            c = FrontDoorClient("127.0.0.1", fd.port)
            body = c.generate(p, 4, deadline_s=60.0)
            results.append((c.last_status, c.last_headers, body))

        threads = [threading.Thread(target=flood, args=(PROMPTS[i % 4],)) for i in range(10)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        rejected = [r for r in results if r[0] == 429]
        assert rejected and all("queue" in r[2]["error"] for r in rejected)
        hinted = [r for r in rejected if r[2].get("retry_after_s") is not None]
        assert hinted and all(int(r[1]["retry-after"]) >= 1 for r in hinted)
        assert daemon.counters["rejected_with_hint"] >= 1
        assert _wait_outstanding_zero(daemon)["conserved"]
        fd.max_connections = 0                      # everything over capacity
        body = cli.healthz()
        assert cli.last_status == 503 and "capacity" in body["error"]
        assert cli.last_headers["retry-after"] == "1"
        fd.max_connections = 64
        daemon.drain(timeout=WAIT_S)
        body = cli.generate(PROMPTS[1], 2)
        assert cli.last_status == 503 and ("draining" in body["error"]
                                           or "closed" in body["error"])


def test_slow_client_408_and_keepalive_pings(weights):
    router = Router(_factory(weights[2]), 1)
    daemon = ServingDaemon(router, max_queue=8)      # not started: a stalled stream
    fd = FrontDoor(daemon, keepalive_s=0.1, max_connections=3,
                   body_timeout_s=1.0).start_in_thread()
    try:
        got = {}

        def consume():
            c = FrontDoorClient("127.0.0.1", fd.port)
            got["tokens"] = list(c.stream(PROMPTS[0], 4))
            got["terminal"], got["last"] = c.last_terminal, c.last_event_id

        t = threading.Thread(target=consume)
        t.start()
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline and fd.counters["keepalive_pings"] < 3:
            time.sleep(0.02)
        assert fd.counters["keepalive_pings"] >= 3
        loris = socket.create_connection(("127.0.0.1", fd.port), timeout=WAIT_S)
        loris.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: t\r\n")   # never finishes
        data = b""
        while b"\r\n\r\n" not in data:
            chunk = loris.recv(4096)
            if not chunk:
                break
            data += chunk
        loris.close()
        assert b"408" in data.split(b"\r\n", 1)[0] and fd.counters["read_timeout"] == 1
        daemon.start()                                 # un-stall the tier
        t.join(timeout=WAIT_S)
        assert not t.is_alive() and got["terminal"]["status"] == "done"
        assert got["tokens"] == list(daemon.stream(daemon.submit(PROMPTS[0], 4),
                                                   timeout=WAIT_S))
        assert got["last"] == len(got["tokens"]) - 1
    finally:
        fd.stop()
        daemon.close()


# --------------------------------------------------------- observability


def test_healthz_metrics_and_one_scrape(weights):
    registry = MetricsRegistry()
    telemetry = Telemetry(registry=registry, interval_s=0.05)
    tracer = Tracer()
    router = Router(_factory(weights[2], telemetry=telemetry, tracer=tracer), 2,
                    telemetry=telemetry, tracer=tracer)
    with _Tier(router, liveness_timeout_s=300.0) as (daemon, fd):
        assert fd.registry is registry
        cli = FrontDoorClient("127.0.0.1", fd.port)
        assert cli.generate(PROMPTS[0], 3)["status"] == "done"
        h = cli.healthz()
        assert cli.last_status == 200 and h["status"] == "ok" and h["healthy"] == 2
        assert set(h["replicas"]) == {"0", "1"} and h["conservation"]["conserved"]
        text = cli.metrics()
        assert "dtm_frontdoor_requests" in text and "dtm_tokens_generated" in text
        daemon.drain(timeout=WAIT_S)
        om = cli.metrics(accept="application/openmetrics-text")
        assert om.rstrip().endswith("# EOF")
        assert any('trace_id="' in line for line in om.splitlines() if " # {" in line)
        assert "# EOF" not in cli.metrics()
        for rep in router.replicas:
            router._fail_replica(rep, RuntimeError("induced for healthz"))
        h = cli.healthz()
        assert cli.last_status == 503 and h["status"] == "degraded" and h["healthy"] == 0
    assert tracer.open_spans == 0


def test_trace_headers_join_and_trace_endpoint(tier):
    daemon, fd, tracer = tier
    cli = FrontDoorClient("127.0.0.1", fd.port)
    out = cli.generate([1, 2, 3], 2)
    assert cli.last_headers["x-request-id"] == str(out["id"])
    assert TraceContext.parse_traceparent(cli.last_headers["traceparent"]).sampled
    list(cli.stream([1, 2], 2, extra_headers={"X-Request-Id": "cli.id:ok-2"}))
    assert cli.last_headers["x-request-id"] == "cli.id:ok-2"
    out = cli.generate([1, 2], 2, extra_headers={"X-Request-Id": "not ok"})
    assert cli.last_headers["x-request-id"] == str(out["id"])
    sent = f"00-{'ab' * 16}-{'cd' * 8}-01"
    cli.generate([1, 2, 3], 2, extra_headers={"traceparent": sent,
                                              "X-Request-Id": "dbg-1"})
    got = TraceContext.parse_traceparent(cli.last_headers["traceparent"])
    assert got.trace_id == "ab" * 16 and got.span_id != "cd" * 8
    daemon.drain(timeout=WAIT_S)
    doc = cli.request_trace("dbg-1")
    assert cli.last_status == 200 and doc["trace_id"] == "ab" * 16
    assert {"http_request", "daemon_request", "request"} <= {e["name"] for e in doc["events"]}
    assert tracer.open_spans == 0


def test_shed_request_keeps_its_span_at_rate_zero(weights):
    tracer = Tracer()
    router = Router(_factory(weights[2], tracer=tracer), 1, tracer=tracer)
    with _Tier(router, fd_kw=dict(trace_sample_rate=0.0)) as (daemon, fd):
        cli = FrontDoorClient("127.0.0.1", fd.port)
        assert cli.generate([1, 2], 2)["status"] == "done"
        daemon.drain(timeout=WAIT_S)
        cli.generate([1, 2], 2)
        assert cli.last_status == 503
        shed = TraceContext.parse_traceparent(cli.last_headers["traceparent"]).trace_id
        sampler = fd.sampler
    assert tracer.open_spans == 0
    forest = trace_forest(tracer.to_doc(sampler=sampler))
    assert shed in forest and "shed" in forest[shed]["names"]
    assert all(tid == shed for tid, f in forest.items() if "http_request" in f["names"])
    assert isinstance(sampler, TraceSampler)
