"""The internet-shaped front door: an asyncio protocol server over the
daemonized serving tier (the port's copy of the JAX package's
``serving/frontend.py``; stdlib only, the wire bytes are JAX's).

Everything below the network edge already behaves like a service —
:class:`~.daemon.ServingDaemon` is long-lived, thread-safe, policy-
admitted, chaos-proven — but its callers are in-process Python.  This
module is the protocol layer that turns the library into a SERVICE
(TensorFlow's own library→serving move, PAPERS.md 1605.08695), built the
TF-Replicator way (1902.00465): the user-facing API is a stable wire
schema, and the execution tier under it can change shape — replicas
failing over, weights hot-swapping, the autoscaler breathing — without
the client ever seeing anything but tokens.

Endpoints (HTTP/1.1, stdlib ``asyncio.start_server`` — no new deps):

* ``POST /v1/generate`` — JSON in (prompt token ids, ``max_new``,
  optional per-request ``sampling``/``priority``/``deadline_s``/SLOs);
  JSON out, or an SSE token stream when ``"stream": true`` (one
  ``data: {"token": t}`` event per token, a terminal ``event: end`` with
  the final status).  Tokens cross from the daemon's delivery thread
  into asyncio via ``loop.call_soon_threadsafe`` — the thread-world →
  event-loop bridge — so SSE order is exactly delivery order and the
  stream inherits the tier's exactly-once guarantee across failover.
* ``GET /healthz`` — replica census (every replica's vitals, dead or
  alive) + the daemon's exact-conservation check; 503 when no healthy
  replica remains.
* ``GET /metrics`` — the existing :class:`~..utils.telemetry.
  MetricsRegistry` Prometheus exposition, snapshotted atomically (the
  registry's own lock) — the front door adds its counters to the SAME
  registry, so one scrape sees the whole tier.

Backpressure maps to status codes instead of buffering: the daemon's
:class:`~.scheduler.QueueFull` becomes **429** and
:class:`~.policies.SLOUnmeetable` (plus a draining/dead tier) becomes
**503**, each carrying ``Retry-After`` from the admission policy's wait
predictor when it has one (``exc.retry_after_s``).
The accept side is bounded too (``max_connections``): past the bound a
connection gets an immediate 503, never an unbounded accept queue.

Client disconnect mid-stream CANCELS the underlying request: the handler
watches the socket for EOF while it streams, and a hangup calls
:meth:`~.daemon.ServingDaemon.cancel` — the slot frees, the KV pages
free, the tracer span closes, and conservation counts it ``cancelled``
(pinned in tests/test_torch_frontend.py).  A disconnected client costs the
tier at most one pump sweep, not a slot leaked until deadline.
EXCEPT when the request carries an ``Idempotency-Key``: a keyed request
survives its client's disconnect — retry-ability is what the key asks
for — and a retried POST with the same key binds to the ORIGINAL
request instead of double-executing (422 when the key is reused with a
different body — the fingerprint check, scheduler.request_fingerprint).
SSE events carry ``id: <logical token index>`` lines, so a reconnecting
client sends ``Last-Event-ID`` and receives exactly the suffix it
missed; ``FrontDoor(idempotency_bindings=recovery.bindings)`` seeds the
dedup table across a process crash (serving/journal.py) — together
these stitch a client transcript exactly-once across resets AND kills.

Two liveness guards on the socket itself: the
head/body read runs under ``body_timeout_s`` — a slow-loris client gets
a 408 (counted ``frontdoor_read_timeout``) instead of holding one of
``max_connections`` slots forever — and idle streams emit ``: ping``
SSE comment frames every ``keepalive_s`` so proxies don't sever long
generations and a silently-dead peer is detected BETWEEN tokens (the
ping's write fails → cancel), not after the full generation is paid.

Distributed tracing: every accepted ``/v1/generate`` mints —
or, when the client sent a W3C ``traceparent`` header, JOINS — a
:class:`~..utils.tracing.TraceContext`, opens an ``http_request`` root
span, and threads the context through ``daemon.submit`` so ONE trace id
names the request from HTTP accept to the last SSE byte, across
failover replays (span links), disagg handoffs, and journal recovery.
Responses echo ``traceparent`` next to ``X-Request-Id``
(client-supplied ids are honored after sanitization);
429/503 sheds record a terminal ``shed`` span the tail sampler always
keeps even at ``trace_sample_rate=0``; ``GET /v1/requests/{id}/trace``
returns the request's correlated span tree; and ``/metrics`` speaks
exemplar-bearing OpenMetrics when the scraper sends
``Accept: application/openmetrics-text``.

Thread model: the server runs on ONE asyncio event loop (optionally on
its own thread via :meth:`FrontDoor.start_in_thread` — the test/bench
harness path).  Handler coroutines touch the daemon only through its
thread-safe surface (``submit``/``cancel``/``conservation``); daemon
threads touch asyncio only through ``call_soon_threadsafe``.  The
frontend's own counters are loop-thread-only ints mirrored into the
registry.

:class:`FrontDoorClient` is the curl-equivalent blocking client
(stdlib ``http.client``) the example, tests, and bench drive the wire
with — including an SSE parser, so parity checks compare the actual
bytes on the wire against :meth:`ServingDaemon.stream`.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import math
import threading
from typing import Iterator

from distributed_tensorflow_ibm_mnist_tpu_torch.serving.policies import SLOUnmeetable
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.sampling import SamplingParams
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.scheduler import (
    QueueFull,
    request_fingerprint,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.tracing import (
    TraceContext,
    TraceSampler,
)

_MAX_BODY = 1 << 20          # 1 MiB request-body bound (413 past it)
_MAX_HEAD = 32 << 10         # request line + headers bound
_SAMPLING_KEYS = ("temperature", "top_p", "top_k", "min_p", "seed")
_MAX_RID = 64                # client X-Request-Id length cap
_RID_OK = set("abcdefghijklmnopqrstuvwxyz"
              "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._:-")
_TRACED_CAP = 512            # request-id -> trace-id map bound


def _sanitize_request_id(raw) -> str | None:
    """Validate a client-supplied ``X-Request-Id``: non-empty, at most
    ``_MAX_RID`` chars, drawn from ``[A-Za-z0-9._:-]``.  Anything else
    returns None and the front door falls back to its own id — a hostile
    header can never inject header-splitting bytes into the echo or an
    unbounded key into the trace map."""
    if not isinstance(raw, str) or not raw:
        return None
    if len(raw) > _MAX_RID or not set(raw) <= _RID_OK:
        return None
    return raw


class _BadRequest(ValueError):
    """Maps to a 400 with the message in the JSON error body."""


def _parse_generate(payload: dict) -> dict:
    """Validate the ``/v1/generate`` body into ``ServingDaemon.submit``
    kwargs.  Every verdict is a :class:`_BadRequest` naming the field —
    a malformed request costs the client a 400, never the tier a slot."""
    if not isinstance(payload, dict):
        raise _BadRequest("body must be a JSON object")
    prompt = payload.get("prompt")
    if (not isinstance(prompt, list) or not prompt
            or not all(isinstance(t, int) and not isinstance(t, bool)
                       for t in prompt)):
        raise _BadRequest("'prompt' must be a non-empty list of token ids")
    max_new = payload.get("max_new")
    if not isinstance(max_new, int) or isinstance(max_new, bool) or max_new < 1:
        raise _BadRequest("'max_new' must be an int >= 1")
    out = {"prompt": prompt, "max_new": max_new,
           "stream": bool(payload.get("stream", False))}
    priority = payload.get("priority", 0)
    if not isinstance(priority, int) or isinstance(priority, bool):
        raise _BadRequest("'priority' must be an int")
    out["priority"] = priority
    for key in ("deadline_s", "ttft_slo_s", "tpot_slo_s"):
        val = payload.get(key)
        if val is not None:
            if not isinstance(val, (int, float)) or isinstance(val, bool) \
                    or not val > 0:
                raise _BadRequest(f"'{key}' must be a number > 0")
            val = float(val)
        out[key] = val
    sampling = payload.get("sampling")
    if sampling is not None:
        if not isinstance(sampling, dict):
            raise _BadRequest("'sampling' must be an object")
        unknown = set(sampling) - set(_SAMPLING_KEYS)
        if unknown:
            raise _BadRequest(
                f"unknown sampling keys {sorted(unknown)} — "
                f"allowed: {list(_SAMPLING_KEYS)}")
        try:
            sampling = SamplingParams(**sampling)
        except (TypeError, ValueError) as e:
            raise _BadRequest(f"bad sampling params: {e}") from None
    out["sampling"] = sampling
    return out


class FrontDoor:
    """HTTP/SSE network edge over one :class:`~.daemon.ServingDaemon`.

    ``port=0`` binds an ephemeral port (read :attr:`port` after start —
    the test/bench pattern).  ``max_connections`` bounds concurrently
    served connections; past it a connection is answered 503 +
    ``Retry-After`` immediately.  ``registry`` is the MetricsRegistry
    ``/metrics`` exposes — default: the daemon's telemetry registry when
    one is wired, else a private one (the endpoint always works).
    """

    def __init__(self, daemon, host: str = "127.0.0.1", port: int = 0, *,
                 max_connections: int = 64, registry=None,
                 keepalive_s: float = 15.0, body_timeout_s: float = 30.0,
                 idempotency_bindings: dict | None = None,
                 tracer=None, trace_sample_rate: float = 1.0):
        if max_connections < 1:
            raise ValueError(
                f"max_connections must be >= 1, got {max_connections}")
        if keepalive_s <= 0:
            raise ValueError(f"keepalive_s must be > 0, got {keepalive_s}")
        if body_timeout_s <= 0:
            raise ValueError(
                f"body_timeout_s must be > 0, got {body_timeout_s}")
        self.daemon = daemon
        self.host = host
        self.port = int(port)          # rebound to the real port at start
        self.max_connections = int(max_connections)
        self.keepalive_s = float(keepalive_s)
        self.body_timeout_s = float(body_timeout_s)
        if registry is None and daemon._telemetry is not None:
            registry = daemon._telemetry.registry
        if registry is None:
            from distributed_tensorflow_ibm_mnist_tpu_torch.utils.telemetry import (
                MetricsRegistry,
            )
            registry = MetricsRegistry()
        self.registry = registry
        # loop-thread-only books (mirrored into the registry for scrapes)
        self.counters = {"connections": 0, "over_capacity": 0,
                         "requests": 0, "streams": 0, "bad_requests": 0,
                         "rejected_429": 0, "rejected_503": 0,
                         "disconnects": 0, "disconnect_cancels": 0,
                         "read_timeout": 0, "keepalive_pings": 0,
                         "idempotent_hits": 0, "idempotent_conflicts": 0,
                         "resumes": 0}
        # Idempotency-Key -> (fingerprint, DaemonRequest): loop-thread-
        # only, like the counters.  Seed with ``recovery.bindings``
        # (serving/journal.Recovery) so retries from before a crash bind
        # to their replayed request — the cross-crash dedup table.
        self._idem: dict[str, tuple[str | None, object]] = {}
        for key, dr in (idempotency_bindings or {}).items():
            self._idem[str(key)] = (getattr(dr, "fingerprint", None), dr)
        # distributed tracing: default to the daemon's tracer so the
        # http_request span parents the daemon/engine spans by plain int
        # id (one in-process tracer end to end); an explicitly different
        # tracer still joins via the span_ctx/parent_ctx hex edges
        self._tracer = (tracer if tracer is not None
                        else getattr(daemon, "_tracer", None))
        self.sampler = TraceSampler(rate=trace_sample_rate)
        # request id (client-supplied or daemon) -> trace id, bounded
        # FIFO — the lookup table behind GET /v1/requests/{id}/trace
        self._traced: dict[str, str] = {}
        self._active = 0
        self._server: asyncio.AbstractServer | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._conn_tasks: set[asyncio.Task] = set()

    def _bump(self, name: str, n: int = 1) -> None:
        self.counters[name] += n
        self.registry.inc(f"frontdoor_{name}", n)

    # ------------------------------------------------------------------
    # distributed tracing

    def _trace_begin(self, headers: dict, **span_args):
        """Mint — or, given a valid client ``traceparent``, JOIN — the
        request's trace context and open the ``http_request`` root span
        on its own viewer track.  The context is built even with no
        tracer wired (the header echo and the journal's trace
        persistence need it); the span carries ``span_ctx`` so a
        different-tracer daemon still connects via the hex edge, and a
        client parent lands as a ``parent_ctx`` edge pointing out of
        this process.  Returns ``(ctx, ts)`` where ``ts`` is the span
        bookkeeping dict (None when tracing is off)."""
        client = TraceContext.parse_traceparent(headers.get("traceparent"))
        if client is not None:
            ctx = client.child()   # same trace id, our own span id,
            #   the CLIENT's head-sampling verdict honored as-is
        else:
            ctx = TraceContext.mint()
            ctx.sampled = self.sampler.head(ctx.trace_id)
        ts = None
        if self._tracer is not None:
            kw = dict(trace=ctx.trace_id, sampled=ctx.sampled,
                      span_ctx=ctx.span_id, **span_args)
            if client is not None:
                kw["parent_ctx"] = client.span_id
            tid = self._tracer.track(f"http {ctx.span_id[:8]}")
            ts = {"span": self._tracer.begin(
                      "http_request", cat="frontdoor", tid=tid, **kw),
                  "tid": tid}
        return ctx, ts

    def _tr_finish(self, ts, status=None, **args) -> None:
        """Close the ``http_request`` root span — idempotent, called on
        EVERY exit path of ``_generate`` (the engine suite pins
        ``open_spans == 0`` after drain; the front door honors the same
        no-leak contract)."""
        if self._tracer is None or ts is None:
            return
        sid = ts.pop("span", None)
        if sid is None:
            return
        self._tracer.end(sid, status=status, **args)

    def _tr_shed(self, ts, code: int, error: str) -> None:
        """Mark a 429/503 rejection: a terminal ``shed`` child span plus
        ``status="shed"`` on the root — BOTH tail-sampler always-keep
        triggers, so shed requests survive export even at
        ``trace_sample_rate=0``."""
        if self._tracer is None or ts is None:
            return
        sid = ts.get("span")
        if sid is not None:
            now = self._tracer.clock()
            self._tracer.complete("shed", now, now, cat="frontdoor",
                                  parent=sid, tid=ts.get("tid", 0),
                                  code=code, error=error)
        self._tr_finish(ts, status="shed", code=code)

    def _remember_trace(self, rid, trace_id: str) -> None:
        m = self._traced
        m[str(rid)] = trace_id
        while len(m) > _TRACED_CAP:
            m.pop(next(iter(m)))

    @staticmethod
    def _trace_headers(rid, ctx) -> dict:
        h = {}
        if rid is not None:
            h["X-Request-Id"] = str(rid)
        if ctx is not None:
            h["traceparent"] = ctx.to_traceparent()
        return h

    # ------------------------------------------------------------------
    # lifecycle

    async def start(self) -> "FrontDoor":
        """Bind and start serving on the RUNNING event loop."""
        if self._server is not None:
            return self
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(
            self._on_connection, self.host, self.port, limit=_MAX_HEAD)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def aclose(self) -> None:
        """Stop accepting, cancel open handlers, close the socket."""
        if self._server is None:
            return
        self._server.close()
        await self._server.wait_closed()
        for task in list(self._conn_tasks):
            task.cancel()
        if self._conn_tasks:
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)
        self._server = None

    def start_in_thread(self) -> "FrontDoor":
        """Run the server on a dedicated event-loop thread; returns once
        the socket is bound (``self.port`` live).  Pair with
        :meth:`stop`; this is the harness path for tests/benches/examples
        whose main thread drives blocking clients."""
        if self._thread is not None:
            return self
        loop = asyncio.new_event_loop()
        ready = threading.Event()
        boot_exc: list[BaseException] = []

        def _run():
            asyncio.set_event_loop(loop)
            try:
                loop.run_until_complete(self.start())
            except BaseException as e:   # bind failure must reach caller
                boot_exc.append(e)
                ready.set()
                return
            ready.set()
            loop.run_forever()

        self._thread = threading.Thread(target=_run, name="dtm-frontdoor",
                                        daemon=True)
        self._thread.start()
        ready.wait()
        if boot_exc:
            self._thread.join(timeout=5.0)
            self._thread = None
            raise boot_exc[0]
        self._loop = loop
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Shut down a :meth:`start_in_thread` server (idempotent)."""
        if self._thread is None:
            return
        fut = asyncio.run_coroutine_threadsafe(self.aclose(), self._loop)
        try:
            fut.result(timeout=timeout)
        finally:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=timeout)
            self._loop.close()
            self._thread = None

    def __enter__(self) -> "FrontDoor":
        return self.start_in_thread()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------
    # connection handling

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        task.add_done_callback(self._conn_tasks.discard)
        self._bump("connections")
        if self._active >= self.max_connections:
            # bounded accept backpressure: answer, never queue unboundedly
            self._bump("over_capacity")
            await self._respond_json(
                writer, 503,
                {"error": "server at connection capacity", "retry_after_s": 1.0},
                extra_headers={"Retry-After": "1"})
            await self._hangup(writer)
            return
        self._active += 1
        try:
            await self._serve_one(reader, writer)
        except (ConnectionResetError, BrokenPipeError, asyncio.CancelledError):
            pass
        except Exception:
            with _swallow():
                await self._respond_json(
                    writer, 500, {"error": "internal server error"})
        finally:
            self._active -= 1
            await self._hangup(writer)

    async def _serve_one(self, reader, writer) -> None:
        try:
            head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"),
                                          timeout=self.body_timeout_s)
        except asyncio.TimeoutError:
            # slow-loris: dribbling (or silent) headers past the read
            # deadline gets a verdict and frees the slot, never holds it
            self._bump("read_timeout")
            await self._respond_json(
                writer, 408, {"error": "request head read timed out"})
            return
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            return
        try:
            request_line, *header_lines = head.decode("latin-1").split("\r\n")
            method, target, _version = request_line.split(" ", 2)
            headers = {}
            for line in header_lines:
                if ":" in line:
                    k, v = line.split(":", 1)
                    headers[k.strip().lower()] = v.strip()
        except ValueError:
            await self._respond_json(writer, 400,
                                     {"error": "malformed request"})
            return
        target = target.split("?", 1)[0]
        if target == "/healthz":
            if method != "GET":
                await self._respond_json(writer, 405,
                                         {"error": "use GET /healthz"})
                return
            await self._healthz(writer)
        elif target == "/metrics":
            if method != "GET":
                await self._respond_json(writer, 405,
                                         {"error": "use GET /metrics"})
                return
            await self._metrics(writer, headers)
        elif target.startswith("/v1/requests/") and target.endswith("/trace"):
            if method != "GET":
                await self._respond_json(
                    writer, 405, {"error": "use GET /v1/requests/{id}/trace"})
                return
            await self._request_trace(writer, target)
        elif target == "/v1/generate":
            if method != "POST":
                await self._respond_json(writer, 405,
                                         {"error": "use POST /v1/generate"})
                return
            await self._generate(reader, writer, headers)
        else:
            await self._respond_json(writer, 404,
                                     {"error": f"no such endpoint {target}"})

    # ------------------------------------------------------------------
    # endpoints

    async def _healthz(self, writer) -> None:
        router = self.daemon.router
        conservation = self.daemon.conservation()
        healthy = len(router.healthy())
        body = {
            "status": ("ok" if healthy and conservation["conserved"]
                       else "degraded"),
            "healthy": healthy,
            "n_replicas": len(router.replicas),
            "retiring": len(router._retiring),
            "replicas": {str(r.index): r.vitals() for r in router.replicas},
            "conservation": conservation,
        }
        await self._respond_json(writer, 200 if healthy else 503, body)

    async def _metrics(self, writer, headers: dict | None = None) -> None:
        # to_prometheus()/to_openmetrics() serialize under the registry
        # lock — the scrape is one atomic snapshot even while pumps are
        # counting.  Content negotiation: an OpenMetrics Accept gets the
        # exemplar-bearing exposition (trace ids on histogram buckets).
        accept = (headers or {}).get("accept", "")
        if "application/openmetrics-text" in accept:
            text = self.registry.to_openmetrics().encode("utf-8")
            ctype = ("application/openmetrics-text; "
                     "version=1.0.0; charset=utf-8")
        else:
            text = self.registry.to_prometheus().encode("utf-8")
            ctype = "text/plain; version=0.0.4"
        await self._respond_raw(writer, 200, text, content_type=ctype)

    async def _request_trace(self, writer, target: str) -> None:
        """``GET /v1/requests/{id}/trace`` — the request's correlated
        span tree (closed events + still-open spans) straight off the
        tracer ring, keyed by the id the response echoed."""
        rid = target[len("/v1/requests/"):-len("/trace")]
        if self._tracer is None:
            await self._respond_json(
                writer, 503, {"error": "no tracer wired to this front door"})
            return
        trace_id = self._traced.get(rid)
        if trace_id is None:
            await self._respond_json(
                writer, 404,
                {"error": f"no trace recorded for request {rid!r}"})
            return
        events = self._tracer.trace_events(trace_id)
        await self._respond_json(
            writer, 200, {"request_id": rid, "trace_id": trace_id,
                          "n_events": len(events), "events": events})

    async def _generate(self, reader, writer, headers: dict) -> None:
        self._bump("requests")
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            length = -1
        if length <= 0:
            self._bump("bad_requests")
            await self._respond_json(
                writer, 400, {"error": "Content-Length body required"})
            return
        if length > _MAX_BODY:
            self._bump("bad_requests")
            await self._respond_json(
                writer, 413, {"error": f"body exceeds {_MAX_BODY} bytes"})
            return
        try:
            body = await asyncio.wait_for(reader.readexactly(length),
                                          timeout=self.body_timeout_s)
            spec = _parse_generate(json.loads(body))
        except _BadRequest as e:
            self._bump("bad_requests")
            await self._respond_json(writer, 400, {"error": str(e)})
            return
        except (json.JSONDecodeError, UnicodeDecodeError):
            self._bump("bad_requests")
            await self._respond_json(writer, 400, {"error": "invalid JSON"})
            return
        except asyncio.TimeoutError:
            # slow-loris body: Content-Length promised bytes that never
            # came — verdict + counter, the connection slot frees
            self._bump("read_timeout")
            await self._respond_json(
                writer, 408, {"error": "request body read timed out"})
            return
        except asyncio.IncompleteReadError:
            return

        # trace begin AFTER the body parsed (a malformed request never
        # costs a span) and BEFORE admission — rejects are traced too
        ctx, ts = self._trace_begin(headers, method="POST",
                                    target="/v1/generate",
                                    stream=spec["stream"])
        client_rid = _sanitize_request_id(headers.get("x-request-id"))

        idem_key = headers.get("idempotency-key") or None
        last_event_id = None
        if "last-event-id" in headers:
            try:
                last_event_id = int(headers["last-event-id"])
            except ValueError:
                self._bump("bad_requests")
                self._tr_finish(ts, status="bad_request")
                await self._respond_json(
                    writer, 400,
                    {"error": "Last-Event-ID must be an integer token index"})
                return
        if idem_key is not None:
            fp = request_fingerprint(spec["prompt"], spec["max_new"],
                                     spec["sampling"])
            bound = self._idem.get(idem_key)
            if bound is not None:
                bound_fp, bound_dr = bound
                if bound_fp is not None and bound_fp != fp:
                    # a key names ONE request forever — reusing it with a
                    # different body is a client bug, not a new request
                    self._bump("idempotent_conflicts")
                    self._tr_finish(ts, status="conflict",
                                    request=bound_dr.id)
                    await self._respond_json(
                        writer, 422,
                        {"error": "Idempotency-Key already bound to a "
                                  "different request body",
                         "id": bound_dr.id})
                    return
                # the retry binds to the ORIGINAL request: no second
                # execution, the stream picks up wherever the client
                # says it left off (Last-Event-ID).  The rebind's OWN
                # http span closes here; the echoed traceparent is the
                # original execution's trace — the one worth looking up
                self._bump("idempotent_hits")
                self._tr_finish(ts, status="rebind", request=bound_dr.id)
                if spec["stream"]:
                    self._bump("streams")
                    self._bump("resumes")
                    await self._stream_resume(reader, writer, bound_dr,
                                              last_event_id,
                                              rid=client_rid)
                else:
                    await self._collect_rebind(writer, bound_dr,
                                               rid=client_rid)
                return

        loop = asyncio.get_running_loop()
        events: asyncio.Queue = asyncio.Queue()

        def on_token(_dr, tok):
            # delivery thread → event loop: the ONE legal crossing
            loop.call_soon_threadsafe(events.put_nowait, ("tok", int(tok)))

        # int-id parenting only works inside ONE tracer; a front door
        # given its own tracer still joins through the hex ctx edges
        tp_parent = (ts["span"] if ts is not None
                     and self._tracer is getattr(self.daemon, "_tracer", None)
                     else None)
        try:
            dr = self.daemon.submit(
                spec["prompt"], spec["max_new"], callback=on_token,
                deadline_s=spec["deadline_s"], priority=spec["priority"],
                ttft_slo_s=spec["ttft_slo_s"], tpot_slo_s=spec["tpot_slo_s"],
                sampling=spec["sampling"], idempotency_key=idem_key,
                trace_ctx=ctx, trace_parent=tp_parent)
        except SLOUnmeetable as e:
            self._bump("rejected_503")
            self._tr_shed(ts, 503, str(e))
            await self._respond_reject(writer, 503, e,
                                       trace=self._trace_headers(
                                           client_rid, ctx))
            return
        except QueueFull as e:
            self._bump("rejected_429")
            self._tr_shed(ts, 429, str(e))
            await self._respond_reject(writer, 429, e,
                                       trace=self._trace_headers(
                                           client_rid, ctx))
            return
        except RuntimeError as e:       # daemon draining/closed
            self._bump("rejected_503")
            self._tr_shed(ts, 503, str(e))
            await self._respond_json(
                writer, 503, {"error": str(e)},
                extra_headers=self._trace_headers(client_rid, ctx))
            return
        except ValueError as e:         # engine-level validation
            self._bump("bad_requests")
            self._tr_finish(ts, status="bad_request")
            await self._respond_json(writer, 400, {"error": str(e)})
            return
        # the id the response echoes (client-supplied when valid) and
        # the daemon id BOTH resolve through /v1/requests/{id}/trace
        rid = client_rid if client_rid is not None else str(dr.id)
        self._remember_trace(rid, ctx.trace_id)
        self._remember_trace(dr.id, ctx.trace_id)

        # the delivery callback only ENQUEUES to this loop — receipt is
        # the drained socket write, so THIS side journals the delivered
        # high-water (per token for SSE; unary clients receive nothing
        # until the end, so a crashed unary request replays from 0)
        dr.external_receipt = True
        if idem_key is not None:
            # bind AFTER a successful submit: a rejected request never
            # occupies its key (the client's retry should get a fresh try)
            self._idem[idem_key] = (fp, dr)

        # end-of-request watcher: a worker thread parks on the request's
        # terminal event and posts the sentinel AFTER every token callback
        # already crossed (the delivery thread runs callbacks before it
        # sets _done, and call_soon_threadsafe preserves order)
        async def _await_end():
            await loop.run_in_executor(None, dr._done.wait)
            events.put_nowait(("end", None))

        end_task = asyncio.ensure_future(_await_end())
        # disconnect watcher: the client sends nothing after the request,
        # so a read completing means EOF/reset — the socket is gone
        disconnect = asyncio.ensure_future(reader.read(1))
        try:
            if spec["stream"]:
                self._bump("streams")
                await self._stream_sse(writer, dr, events, disconnect,
                                       rid=rid)
            else:
                await self._collect_json(writer, dr, events, disconnect,
                                         rid=rid, ctx=ctx)
        finally:
            disconnect.cancel()
            end_task.cancel()
            with _swallow():
                await asyncio.gather(end_task, disconnect,
                                     return_exceptions=True)
            # the root span covers accept -> last byte written: close it
            # here, after the stream/collect finished (or died), with
            # the request's terminal verdict as the tail-keep signal
            self._tr_finish(ts, status=dr.status, request=dr.id)

    async def _next_event(self, events: asyncio.Queue,
                          disconnect: asyncio.Task,
                          timeout: float | None = None):
        """One delivery event, or ``("disconnect", None)`` the moment the
        client hangs up with nothing pending — pending tokens drain first
        (they are already paid for; the disconnect verdict can wait one
        queue pop).  With ``timeout`` (the keep-alive interval), an idle
        wait yields ``("ping", None)`` instead of parking forever."""
        if not events.empty():
            return events.get_nowait()
        getter = asyncio.ensure_future(events.get())
        done, _pending = await asyncio.wait(
            {getter, disconnect}, timeout=timeout,
            return_when=asyncio.FIRST_COMPLETED)
        if getter in done:
            return getter.result()
        getter.cancel()
        with _swallow():
            await getter
        if disconnect in done:
            return ("disconnect", None)
        return ("ping", None)

    def _cancel_on_disconnect(self, dr) -> None:
        self._bump("disconnects")
        if dr.idempotency_key is not None:
            # a keyed request SURVIVES its client's disconnect — retry-
            # ability is what the key asks for: it stays bound in the
            # dedup table and keeps generating, so the retried POST
            # resumes a live stream instead of a cancelled stump
            return
        if not dr.done:
            self.daemon.cancel(dr, reason="client disconnected")
            self._bump("disconnect_cancels")

    def _journal_hw(self, dr, hw: int) -> None:
        """Journal the delivered high-water AFTER a drained socket write
        — the only point where the front door knows the client's kernel
        has the bytes.  On loopback a SIGKILL still flushes drained
        data, so this mark never overstates what the client received."""
        j = self.daemon._journal
        if j is None:
            return
        try:
            j.delivered(dr.id, hw)
        except Exception:
            self.daemon._count("journal_errors")

    def _sse_head(self, dr, rid=None) -> bytes:
        head = (b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: text/event-stream\r\n"
                b"Cache-Control: no-cache\r\n"
                b"Connection: close\r\n"
                + f"X-Request-Id: {dr.id if rid is None else rid}\r\n"
                .encode())
        # streams echo traceparent too — derived from the
        # request itself so idempotent rebinds echo the ORIGINAL trace
        tctx = getattr(dr, "trace_ctx", None)
        if tctx is not None:
            head += f"traceparent: {tctx.to_traceparent()}\r\n".encode()
        return head + b"\r\n"

    @staticmethod
    def _sse_token(idx: int, token: int) -> bytes:
        # the id: line is the resume cursor — a client that reconnects
        # sends it back as Last-Event-ID and gets exactly the suffix
        return (f"id: {idx}\n".encode() + b"data: "
                + json.dumps({"token": token}).encode() + b"\n\n")

    def _sse_terminal(self, dr) -> bytes:
        terminal = {"id": dr.id, "status": dr.status, "error": dr.error,
                    "n_tokens": dr.total_tokens}
        return (b"event: end\ndata: "
                + json.dumps(terminal).encode() + b"\n\n")

    async def _stream_sse(self, writer, dr, events, disconnect,
                          rid=None) -> None:
        writer.write(self._sse_head(dr, rid=rid))
        idx = dr.resume_from   # 0 for every front-door-fresh request
        try:
            await writer.drain()
            while True:
                kind, payload = await self._next_event(
                    events, disconnect, timeout=self.keepalive_s)
                if kind == "tok":
                    writer.write(self._sse_token(idx, payload))
                    idx += 1
                    await writer.drain()
                    self._journal_hw(dr, idx)
                elif kind == "end":
                    writer.write(self._sse_terminal(dr))
                    await writer.drain()
                    return
                elif kind == "ping":
                    # idle heartbeat: keeps proxies from severing a slow
                    # generation AND probes the peer — writing to a dead
                    # socket raises here, between tokens, not after the
                    # whole generation was paid for
                    self._bump("keepalive_pings")
                    writer.write(b": ping\n\n")
                    await writer.drain()
                else:
                    self._cancel_on_disconnect(dr)
                    return
        except (ConnectionResetError, BrokenPipeError):
            self._cancel_on_disconnect(dr)

    async def _stream_resume(self, reader, writer, dr, last_event_id,
                             rid=None) -> None:
        """Serve an idempotent-retry SSE rebind by POLLING ``dr.tokens``
        growth (list append is atomic; the single-slot delivery callback
        belongs to the original connection, so a rebind cannot ride the
        queue path).  Starts after ``Last-Event-ID`` when the client
        sent one, else at the earliest token this process can serve
        (``dr.resume_from`` — pre-crash tokens below it were delivered
        to, and journaled against, the pre-crash stream)."""
        writer.write(self._sse_head(dr, rid=rid))
        start = dr.resume_from if last_event_id is None else last_event_id + 1
        idx = max(start, dr.resume_from)
        disconnect = asyncio.ensure_future(reader.read(1))
        try:
            await writer.drain()
            idle_s = 0.0
            while True:
                wrote = False
                while idx < dr.total_tokens:
                    writer.write(self._sse_token(
                        idx, dr.tokens[idx - dr.resume_from]))
                    idx += 1
                    wrote = True
                if wrote:
                    idle_s = 0.0
                    await writer.drain()
                    self._journal_hw(dr, idx)
                if dr.done and idx >= dr.total_tokens:
                    writer.write(self._sse_terminal(dr))
                    await writer.drain()
                    return
                if disconnect.done():
                    self._cancel_on_disconnect(dr)
                    return
                if idle_s >= self.keepalive_s:
                    idle_s = 0.0
                    self._bump("keepalive_pings")
                    writer.write(b": ping\n\n")
                    await writer.drain()
                await asyncio.sleep(0.005)
                idle_s += 0.005
        except (ConnectionResetError, BrokenPipeError):
            self._cancel_on_disconnect(dr)
        finally:
            disconnect.cancel()
            with _swallow():
                await disconnect

    async def _collect_rebind(self, writer, dr, rid=None) -> None:
        """Unary idempotent retry: wait out the ORIGINAL request and
        return its verdict — one execution, however many retries."""
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, dr._done.wait)
        body = {"id": dr.id, "status": dr.status, "error": dr.error,
                "tokens": list(dr.tokens), "resume_from": dr.resume_from}
        try:
            await self._respond_json(
                writer, 200, body,
                extra_headers=self._trace_headers(
                    dr.id if rid is None else rid,
                    getattr(dr, "trace_ctx", None)))
        except (ConnectionResetError, BrokenPipeError):
            self._bump("disconnects")

    async def _collect_json(self, writer, dr, events, disconnect,
                            rid=None, ctx=None) -> None:
        while True:
            kind, _payload = await self._next_event(events, disconnect)
            if kind == "end":
                break
            if kind == "disconnect":
                # keyed requests keep running for a future retry
                # (_cancel_on_disconnect skips the cancel) — but THIS
                # socket is gone either way, stop serving it
                self._cancel_on_disconnect(dr)
                return
        body = {"id": dr.id, "status": dr.status, "error": dr.error,
                "tokens": list(dr.tokens)}
        try:
            await self._respond_json(
                writer, 200, body,
                extra_headers=self._trace_headers(
                    dr.id if rid is None else rid, ctx))
        except (ConnectionResetError, BrokenPipeError):
            self._bump("disconnects")

    # ------------------------------------------------------------------
    # response plumbing

    async def _respond_reject(self, writer, code: int, exc: QueueFull,
                              trace: dict | None = None) -> None:
        """429/503 with the policy's backoff hint as a real Retry-After
        header (integer seconds, ceil — never rounded to an instant
        retry) AND machine-readable in the body; ``trace`` carries the
        X-Request-Id/traceparent echo so a shed request is findable."""
        hint = getattr(exc, "retry_after_s", None)
        extra = dict(trace or {})
        if hint is not None:
            extra["Retry-After"] = str(max(1, math.ceil(hint)))
        await self._respond_json(
            writer, code,
            {"error": str(exc),
             "retry_after_s": None if hint is None else round(float(hint), 6)},
            extra_headers=extra or None)

    async def _respond_json(self, writer, code: int, body: dict,
                            extra_headers: dict | None = None) -> None:
        await self._respond_raw(
            writer, code, json.dumps(body).encode("utf-8"),
            content_type="application/json", extra_headers=extra_headers)

    async def _respond_raw(self, writer, code: int, body: bytes, *,
                           content_type: str,
                           extra_headers: dict | None = None) -> None:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  405: "Method Not Allowed", 408: "Request Timeout",
                  413: "Payload Too Large", 422: "Unprocessable Entity",
                  429: "Too Many Requests", 500: "Internal Server Error",
                  503: "Service Unavailable"}.get(code, "Unknown")
        head = [f"HTTP/1.1 {code} {reason}",
                f"Content-Type: {content_type}",
                f"Content-Length: {len(body)}",
                "Connection: close"]
        for k, v in (extra_headers or {}).items():
            head.append(f"{k}: {v}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body)
        await writer.drain()

    async def _hangup(self, writer) -> None:
        with _swallow():
            writer.close()
            await writer.wait_closed()


class _swallow:
    """``with _swallow():`` — an async-teardown guard: nothing raised
    while closing an already-dead socket should replace the real story."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return True


# ----------------------------------------------------------------------
# the curl-equivalent client (stdlib http.client) — example/tests/bench


class FrontDoorClient:
    """Blocking wire client for one :class:`FrontDoor`.

    Every call opens a fresh connection (the server is
    ``Connection: close``).  :meth:`generate` returns the parsed JSON
    verdict; :meth:`stream` yields tokens off the SSE wire as they
    arrive and stores the terminal event on :attr:`last_terminal` —
    byte-level parity with :meth:`ServingDaemon.stream` is exactly what
    the bench gates.
    """

    def __init__(self, host: str, port: int, timeout: float = 60.0):
        self.host = host
        self.port = int(port)
        self.timeout = float(timeout)
        self.last_terminal: dict | None = None
        self.last_status: int | None = None
        self.last_headers: dict | None = None
        # highest SSE id: seen on the most recent stream() — what a
        # reconnect sends as Last-Event-ID to resume exactly-once
        self.last_event_id: int | None = None

    def _request(self, method: str, path: str, payload: dict | None = None,
                 headers: dict | None = None):
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        body = None if payload is None else json.dumps(payload)
        send_headers = ({"Content-Type": "application/json"}
                        if body is not None else {})
        send_headers.update(headers or {})
        conn.request(method, path, body=body, headers=send_headers)
        resp = conn.getresponse()
        self.last_status = resp.status
        self.last_headers = {k.lower(): v for k, v in resp.getheaders()}
        return conn, resp

    def _json_call(self, method: str, path: str,
                   payload: dict | None = None,
                   headers: dict | None = None) -> dict:
        conn, resp = self._request(method, path, payload, headers)
        try:
            raw = resp.read()
        finally:
            conn.close()
        try:
            return json.loads(raw)
        except json.JSONDecodeError:
            return {"raw": raw.decode("utf-8", "replace")}

    @staticmethod
    def _retry_headers(idempotency_key, last_event_id) -> dict:
        h = {}
        if idempotency_key is not None:
            h["Idempotency-Key"] = str(idempotency_key)
        if last_event_id is not None:
            h["Last-Event-ID"] = str(int(last_event_id))
        return h

    def generate(self, prompt, max_new: int, *,
                 idempotency_key: str | None = None,
                 extra_headers: dict | None = None, **kw) -> dict:
        """POST /v1/generate, non-streaming; returns the JSON body (the
        ``tokens`` list on 200, the error + ``retry_after_s`` on 4xx/5xx;
        check :attr:`last_status`).  ``idempotency_key`` makes the call
        safe to re-issue after a connection reset: the retry binds to
        the original execution.  ``extra_headers`` rides along verbatim
        (``X-Request-Id``, ``traceparent``, ...)."""
        payload = {"prompt": [int(t) for t in prompt],
                   "max_new": int(max_new), **kw}
        send = self._retry_headers(idempotency_key, None)
        send.update(extra_headers or {})
        return self._json_call("POST", "/v1/generate", payload, send)

    def stream(self, prompt, max_new: int, *,
               idempotency_key: str | None = None,
               last_event_id: int | None = None,
               extra_headers: dict | None = None, **kw) -> Iterator[int]:
        """POST /v1/generate with ``stream: true``; yields each token as
        its SSE event arrives.  On a non-200 the rejection body lands in
        :attr:`last_terminal` and nothing is yielded.  Each event's
        ``id:`` updates :attr:`last_event_id`; pass it back (with the
        same ``idempotency_key``) to resume a severed stream from
        exactly the next token."""
        payload = {"prompt": [int(t) for t in prompt],
                   "max_new": int(max_new), "stream": True, **kw}
        self.last_terminal = None
        self.last_event_id = None if last_event_id is None else int(last_event_id)
        send = self._retry_headers(idempotency_key, last_event_id)
        send.update(extra_headers or {})
        conn, resp = self._request("POST", "/v1/generate", payload, send)
        try:
            if resp.status != 200:
                raw = resp.read()
                try:
                    self.last_terminal = json.loads(raw)
                except json.JSONDecodeError:
                    self.last_terminal = {"raw": raw.decode("utf-8", "replace")}
                return
            for event, data, eid in _iter_sse(resp):
                if event == "end":
                    self.last_terminal = data
                    return
                if eid is not None:
                    self.last_event_id = eid
                yield int(data["token"])
        finally:
            conn.close()

    def healthz(self) -> dict:
        return self._json_call("GET", "/healthz")

    def request_trace(self, request_id) -> dict:
        """GET /v1/requests/{id}/trace — the span tree the front door
        recorded for ``request_id`` (client-supplied or daemon id)."""
        return self._json_call("GET", f"/v1/requests/{request_id}/trace")

    def metrics(self, accept: str | None = None) -> str:
        """GET /metrics; pass ``accept="application/openmetrics-text"``
        for the exemplar-bearing OpenMetrics exposition."""
        conn, resp = self._request(
            "GET", "/metrics",
            headers=None if accept is None else {"Accept": accept})
        try:
            return resp.read().decode("utf-8")
        finally:
            conn.close()


def _iter_sse(resp) -> Iterator[tuple[str, dict, int | None]]:
    """Parse an SSE byte stream into ``(event, json_data, id)`` triples.
    ``event`` is ``"message"`` for bare ``data:`` lines (tokens) and the
    explicit event name otherwise (the terminal ``end``).  ``id`` is the
    logical token index from the event's ``id:`` line, ``None`` when the
    event carries none (the terminal).  ``:`` comment lines (keep-alive
    pings) are skipped."""
    event = "message"
    event_id: int | None = None
    data_lines: list[str] = []
    for raw in resp:
        line = raw.decode("utf-8").rstrip("\n").rstrip("\r")
        if line.startswith(":"):
            continue  # comment frame — keep-alive ping, not an event
        if line.startswith("event:"):
            event = line[len("event:"):].strip()
        elif line.startswith("id:"):
            try:
                event_id = int(line[len("id:"):].strip())
            except ValueError:
                event_id = None
        elif line.startswith("data:"):
            data_lines.append(line[len("data:"):].strip())
        elif line == "" and data_lines:
            yield event, json.loads("\n".join(data_lines)), event_id
            event = "message"
            event_id = None
            data_lines = []
