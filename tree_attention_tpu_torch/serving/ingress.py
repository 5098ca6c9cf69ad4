"""Streaming HTTP ingress for the serving engine.

Counterpart of ``tree_attention_tpu/serving/ingress.py`` for one engine:

- ``POST /v1/completions`` — the OpenAI completions shape (``prompt`` as a
  token-id list, ``max_tokens``, ``stream``, and the sampling and fork
  fields ``temperature``, ``top_k``, ``seed``, ``n``, ``best_of``,
  ``fork_at``), answered as an SSE token stream (or, with ``"stream":
  false``, one JSON body) fed from the engine's one host fetch per tick:
  the engine's per-branch callbacks hand each token to a per-request queue
  and the handler thread drains it, so streaming adds no device sync.
  ``n > 1`` completions interleave on ONE stream, each event's
  ``choices[0].index`` naming its branch, one finish per branch, then
  ``[DONE]``; a whole body carries ``n`` choices. ``best_of`` streams only
  the winning branch (as index 0) once the family has finished; branches a
  ``fork_at`` adds stream under their own index but never hold the close.
- **Client-disconnect cancellation** — a write to a vanished client (or the
  keepalive probe between tokens) raises; the handler calls
  :meth:`SlotServer.cancel`, and the next tick's control sweep retires the
  request mid-flight: slot freed, prefix pins released, paged blocks back
  in the pool (a host-side unmap: no KV byte moves).
- **Per-request deadlines** — ``deadline_s`` in the body (or the server's
  default) becomes an absolute engine deadline: expired in the queue the
  request finishes unserved, in flight it retires with ``deadline``.
- **Backpressure** — past ``max_queue`` requests waiting for their first
  token a submission gets ``429`` with ``Retry-After``:
  ``ceil(depth x max(ttft_p50, 50 ms) / slots)``, clamped to [1, 60] s.
- **Graceful drain** — SIGTERM (:func:`install_drain_signals`), ``POST
  /admin/drain`` or :meth:`IngressServer.drain` stops admission (new
  submissions get 503), sheds the queued backlog, finishes the in-flight
  requests, and lets ``serve()`` return; :meth:`IngressServer.join`
  collects its report.

Threading: the engine loop runs on its own thread under ``no_grad``
(:meth:`SlotServer.serve`), on that thread's current CUDA stream, so every
launch of a tick stays on one stream. Handler threads never touch engine
state: they go through three thread-safe seams
(:meth:`QueueRequestSource.submit`, :meth:`SlotServer.cancel`,
:meth:`SlotServer.request_drain`), mailboxes the loop sweeps at tick
start. Ingress-local state is mutated only under ``self._lock``.
"""

from __future__ import annotations

import itertools
import json
import math
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, List, Optional

import numpy as np

from tree_attention_tpu_torch import obs
from tree_attention_tpu_torch.serving.engine import (
    OUTCOME_BUDGET,
    OUTCOME_EOS,
    Request,
    RequestResult,
    RequestSource,
    ServeReport,
    SlotServer,
)
from tree_attention_tpu_torch.utils.httpd import DaemonHTTPServer
from tree_attention_tpu_torch.utils.logging import get_logger

log = get_logger("serving.ingress")

# Request uids are minted process-wide (``next`` on a count is atomic under
# the GIL): two ingresses in one process never hand out the same uid.
_UID_COUNTER = itertools.count()

_HTTP_REQUESTS = obs.counter(
    "serving_http_requests_total",
    "ingress HTTP requests answered, by route and status code",
    labels=("route", "code"),
)
_DISCONNECTS = obs.counter(
    "serving_sse_disconnects_total",
    "SSE streams whose client vanished mid-stream (each cancels its "
    "request)",
)
_QUEUE_DEPTH = obs.gauge(
    "serving_ingress_queue_depth",
    "requests submitted to the ingress but not yet streaming tokens",
)

#: Engine outcome -> finish_reason: the OpenAI words on the happy arcs, the
#: engine's own names on the robustness arcs (a client that set a deadline
#: sees "deadline").
FINISH_REASONS = {OUTCOME_EOS: "stop", OUTCOME_BUDGET: "length"}

_RETRY_AFTER_MIN_TTFT_S = 0.05
_RETRY_AFTER_MAX_S = 60
# A handler gives up on an engine thread that died after this much
# silence (a live engine may be silent longer: its deadline_s bounds it).
_DEAD_ENGINE_S = 30.0


class QueueRequestSource(RequestSource):
    """Thread-safe live feeder: HTTP handlers submit, the tick loop polls.

    ``self._lock`` is a :class:`threading.Condition`: :meth:`submit`
    notifies, so an idle engine blocked in :meth:`wait` wakes on the
    submission instead of at its next poll.
    """

    def __init__(self):
        self._lock = threading.Condition()
        self._queue: List[Request] = []
        self._closed = False

    def submit(self, req: Request) -> bool:
        """Queue one request (any thread); False once closed (draining).
        Stamps ``visible_at``, so the engine's queue-wait and TTFT clocks
        start now."""
        with self._lock:
            if self._closed:
                return False
            req.visible_at = time.monotonic()
            self._queue.append(req)
            self._lock.notify_all()
            return True

    def poll(self, tick: int) -> List[Request]:
        with self._lock:
            out = self._queue
            self._queue = []
        for r in out:
            # No synthetic arrival time: the tick that first saw it.
            r.arrival_tick = tick
        return out

    def wait(self, timeout: float) -> bool:
        with self._lock:
            if self._queue or self._closed:
                return True
            self._lock.wait(timeout)
            return bool(self._queue)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()

    @property
    def exhausted(self) -> bool:
        with self._lock:
            return self._closed and not self._queue


class IngressServer(DaemonHTTPServer):
    """The serving front door: one engine thread, a thread per connection.

    Args:
      engine: the :class:`SlotServer` to serve from. :meth:`start` runs its
        tick loop on a thread of its own against a
        :class:`QueueRequestSource`; :meth:`drain` winds it down.
      max_queue: bound on requests submitted but not yet streaming; past it
        submissions get 429 with ``Retry-After``.
      default_deadline_s: deadline (seconds from submission) for requests
        that carry no ``deadline_s`` (None: no default).
      default_max_tokens: ``max_tokens`` for bodies that omit it.
      keepalive_s: seconds between SSE keepalive comments while no token is
        ready — the probe that finds a vanished client between tokens.
    """

    thread_name = "serving-ingress"

    def __init__(
        self,
        engine: SlotServer,
        *,
        port: int = 0,
        host: str = "127.0.0.1",
        max_queue: int = 64,
        default_deadline_s: Optional[float] = None,
        default_max_tokens: int = 16,
        keepalive_s: float = 0.5,
    ):
        super().__init__(port, host)
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.engine = engine
        self.max_queue = max_queue
        self.default_deadline_s = default_deadline_s
        self.default_max_tokens = default_max_tokens
        self.keepalive_s = keepalive_s
        self.source = QueueRequestSource()
        # Reentrant: drain() runs in the SIGTERM handler on the main
        # thread, which may interrupt that thread while it holds the lock.
        self._lock = threading.RLock()
        self._queued = 0  # submitted, first token not yet streamed
        self._draining = False
        self._engine_thread: Optional[threading.Thread] = None
        self._report: Optional[ServeReport] = None
        self._engine_error: Optional[BaseException] = None

    # -- lifecycle --------------------------------------------------------

    def start(self) -> int:
        port = super().start()
        with self._lock:
            if self._engine_thread is None:
                self._engine_thread = threading.Thread(
                    target=self._run_engine, name="serving-engine",
                    daemon=True)
                self._engine_thread.start()
        log.info("serving ingress: http://%s:%d/v1/completions",
                 self._host, port)
        return port

    def _run_engine(self) -> None:
        try:
            report = self.engine.serve(self.source)
        except BaseException as e:
            log.exception("engine loop crashed; ingress is dead")
            with self._lock:
                self._engine_error = e
            return
        with self._lock:
            self._report = report

    def drain(self) -> None:
        """Graceful shutdown, phase one (thread-safe, idempotent): stop
        admitting (new POSTs get 503), shed the queue, let in-flight
        requests finish. The engine loop then returns; :meth:`join`
        collects its report."""
        with self._lock:
            if self._draining:
                return
            self._draining = True
        log.info("ingress drain: admission stopped, finishing in-flight")
        self.engine.request_drain()

    def join(self, timeout: Optional[float] = None) -> Optional[ServeReport]:
        """Wait for the engine loop to drain; its ServeReport (None while it
        runs at ``timeout``, or if it crashed: see :attr:`engine_error`)."""
        with self._lock:
            t = self._engine_thread
        if t is not None:
            t.join(timeout)
        with self._lock:
            return self._report

    def stop(self) -> None:
        """Drain, collect the engine, then close the HTTP server."""
        self.drain()
        self.join(timeout=60.0)
        super().stop()

    @property
    def report(self) -> Optional[ServeReport]:
        with self._lock:
            return self._report

    @property
    def engine_error(self) -> Optional[BaseException]:
        """The exception that killed the engine loop, if any (an exit code
        must not take a crash for a drain)."""
        with self._lock:
            return self._engine_error

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return self._queued

    # -- routing ----------------------------------------------------------

    def handle(self, method: str, req: BaseHTTPRequestHandler) -> None:
        path = req.path.split("?", 1)[0].rstrip("/") or "/"
        if method == "POST" and path == "/v1/completions":
            self._completions(req)
            return
        # The other routes ignore a request body, but read it all the same:
        # a socket closed with unread bytes is reset, and the reset can
        # reach the client before it has read the reply.
        self._discard_body(req)
        if method == "POST" and path == "/admin/drain":
            # A remote drain (a supervisor's): answered before the drain
            # completes; /ingress/stats says when the engine is done.
            self.drain()
            self._reply_counted(req, "drain", 202,
                                json.dumps({"draining": True}),
                                "application/json")
        elif method == "GET" and path == "/ingress/stats":
            self._reply_counted(req, "stats", 200,
                                json.dumps(self._stats(), indent=2),
                                "application/json")
        else:
            self._reply_counted(req, "other", 404,
                                f"no such endpoint: {method} {path}\n",
                                "text/plain")

    def _engine_alive(self) -> bool:
        with self._lock:
            return (self._engine_thread is not None
                    and self._engine_thread.is_alive()
                    and self._engine_error is None)

    def _stats(self) -> Dict[str, Any]:
        alive = self._engine_alive()
        with self._lock:
            out = {
                "queue_depth": self._queued,
                "max_queue": self.max_queue,
                "draining": self._draining,
                "engine_done": self._report is not None,
                "engine_alive": alive,
                # A router may send work here iff the loop is up and not
                # draining.
                "ready": alive and not self._draining,
            }
        out["slots"] = self.engine.slots
        out["goodput"] = round(self.engine.slo.goodput(), 4)
        return out

    @staticmethod
    def _discard_body(req: BaseHTTPRequestHandler) -> None:
        try:
            n = int(req.headers.get("Content-Length", 0))
        except ValueError:
            return
        if n > 0:
            req.rfile.read(n)

    def _reply_counted(self, req, route: str, code: int, body: str,
                       ctype: str, headers: Optional[dict] = None) -> None:
        if obs.REGISTRY.enabled:
            _HTTP_REQUESTS.labels(route=route, code=str(code)).inc()
        self.reply(req, code, body, ctype, headers)

    # -- the completions endpoint ------------------------------------------

    def _completions(self, req: BaseHTTPRequestHandler) -> None:
        body, err = self._parse_body(req)
        if err is not None:
            self._reply_counted(req, "completions", 400, _error_json(err),
                                "application/json")
            return
        # Admission control before any engine state is touched: drain beats
        # backpressure beats service.
        with self._lock:
            if self._draining:
                depth, verdict = self._queued, 503
            elif self._queued >= self.max_queue:
                depth, verdict = self._queued, 429
            else:
                self._queued += 1
                depth, verdict = self._queued, 200
                uid = next(_UID_COUNTER)
        if verdict == 503:
            self._reply_counted(
                req, "completions", 503,
                _error_json("server is draining; not accepting requests"),
                "application/json")
            return
        if verdict == 429:
            retry = self._retry_after(depth)
            self._reply_counted(
                req, "completions", 429,
                _error_json(f"admission queue full ({depth} waiting); "
                            f"retry in ~{retry}s", type="overloaded"),
                "application/json", headers={"Retry-After": retry})
            return
        if obs.REGISTRY.enabled:
            _QUEUE_DEPTH.set(depth)

        # Trace context: adopt the client's W3C traceparent, or mint one.
        parsed = obs.parse_traceparent(
            req.headers.get(obs.TRACEPARENT_HEADER, ""))
        adopted = parsed is not None
        if parsed is None:
            parsed = (obs.new_trace_id(), obs.new_span_id())

        events: "queue.Queue" = queue.Queue()
        deadline = body.get("deadline_s", self.default_deadline_s)
        # The finishes that end the response: one per completion, or ONE
        # for best_of (the engine streams only the winner, as index 0).
        best_of = body.get("best_of")
        n_expected = 1 if (best_of or 0) > 1 else body["n"]
        request = Request(
            uid=uid,
            prompt=np.asarray(body["prompt"], np.int32),
            max_new_tokens=body["max_tokens"],
            eos_id=body.get("eos_id"),
            deadline_s=(time.monotonic() + deadline
                        if deadline is not None else None),
            temperature=body.get("temperature"),
            top_k=body.get("top_k"),
            seed=body.get("seed"),
            n=body["n"],
            best_of=best_of,
            fork_at=body.get("fork_at"),
            trace=parsed,
            on_branch_token=lambda i, t: events.put(("token", (i, t))),
            on_branch_finish=lambda i, res: events.put(("finish", (i, res))),
        )
        # Whichever comes first — first token, finish, or a disconnect —
        # releases the request's one unit of admission-queue depth.
        deq_state = [False]

        def dequeue_once() -> None:
            if not deq_state[0]:
                deq_state[0] = True
                self._dequeued()

        if obs.TRACER.active:
            # The flow's start ("s") or, behind a relay that started it, a
            # step ("t"), anchored on a named slice.
            with obs.span("ingress_submit", cat="serving",
                          args={"rid": uid, "trace_id": parsed[0],
                                "adopted": adopted}):
                obs.flow("t" if adopted else "s", obs.flow_id(parsed[0]))
                submitted = self.source.submit(request)
        else:
            submitted = self.source.submit(request)
        if not submitted:
            dequeue_once()
            self._reply_counted(
                req, "completions", 503,
                _error_json("server is draining; not accepting requests"),
                "application/json")
            return
        try:
            if body.get("stream", True):
                self._stream_sse(req, uid, events, dequeue_once, n_expected)
            else:
                self._respond_whole(req, uid, events, dequeue_once,
                                    n_expected)
        except BaseException as e:
            # Any handler failure — a vanished client (BrokenPipe,
            # ConnectionReset, timeouts) or a bug — cancels the engine
            # request and releases its queue unit, or max_queue such
            # failures would brick the server with 429s.
            if isinstance(e, OSError):
                if obs.REGISTRY.enabled:
                    _DISCONNECTS.inc()
            else:
                log.exception("completions handler failed (rid %d)", uid)
            self.engine.cancel(uid)
            dequeue_once()
            self._await_finish(events, n_expected)
            raise  # DaemonHTTPServer swallows the socket kinds

    def _parse_body(self, req: BaseHTTPRequestHandler):
        try:
            n = int(req.headers.get("Content-Length", 0))
            body = json.loads(req.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            return None, f"unreadable JSON body: {e}"
        if not isinstance(body, dict):
            return None, "the body must be a JSON object"
        prompt = body.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) and not isinstance(t, bool)
                           for t in prompt)):
            return None, ("body.prompt must be a non-empty list of token ids "
                          "(the server takes token ids; there is no "
                          "tokenizer)")
        if not all(-(1 << 31) <= t < (1 << 31) for t in prompt):
            # Here, so the int32 conversion after admission cannot raise.
            return None, "body.prompt token ids must fit int32"
        # Every numeric field is coerced before the queue unit is taken: a
        # malformed one after it would leak admission depth.
        try:
            body["max_tokens"] = int(body.get("max_tokens",
                                              self.default_max_tokens))
            body["n"] = int(body.get("n", 1))
            for key, cast in (("deadline_s", float), ("eos_id", int),
                              ("temperature", float), ("top_k", int),
                              ("seed", int), ("best_of", int),
                              ("fork_at", int)):
                if body.get(key) is not None:
                    body[key] = cast(body[key])
        except (TypeError, ValueError) as e:
            return None, (f"non-numeric max_tokens/deadline_s/eos_id/"
                          f"temperature/top_k/seed/n/best_of/fork_at: {e}")
        if body["n"] < 1:
            return None, "body.n must be >= 1"
        if body.get("best_of") is not None and body["best_of"] < 1:
            return None, "body.best_of must be >= 1"
        if (body.get("best_of") or 0) > 1 and body["n"] != 1:
            return None, ("body.best_of runs server-side selection and "
                          "streams ONE winner — it requires n == 1")
        if body.get("temperature") is not None and body["temperature"] < 0:
            return None, "body.temperature must be >= 0"
        if body.get("top_k") is not None and body["top_k"] < 0:
            return None, "body.top_k must be >= 0 (0 = off)"
        if body.get("fork_at") is not None and body["fork_at"] < 1:
            return None, "body.fork_at must be >= 1"
        return body, None

    def _retry_after(self, depth: int) -> int:
        """Seconds until a slot-share plausibly frees: queue depth times the
        SLO window's TTFT p50 (at least 50 ms), over the slots."""
        ttft = max(self.engine.slo.snapshot().get("ttft_p50_s", 0.0),
                   _RETRY_AFTER_MIN_TTFT_S)
        est = math.ceil(depth * ttft / max(self.engine.slots, 1))
        return max(1, min(est, _RETRY_AFTER_MAX_S))

    def _dequeued(self) -> None:
        """One request left the TTFT phase (first token, or finished
        without one)."""
        with self._lock:
            self._queued -= 1
            depth = self._queued
        if obs.REGISTRY.enabled:
            _QUEUE_DEPTH.set(depth)

    @staticmethod
    def _await_finish(events: "queue.Queue", n_expected: int = 1) -> None:
        """After a disconnect: drain callback events until the engine
        retires every expected branch of the request (or goes silent), so
        the queue and the Request the engine holds can be collected."""
        seen = 0
        while True:
            try:
                kind, payload = events.get(timeout=_DEAD_ENGINE_S)
            except queue.Empty:
                return  # engine gone; nothing more to free
            if kind == "finish" and payload[0] < n_expected:
                seen += 1
                if seen >= n_expected:
                    return

    # -- response writers --------------------------------------------------

    def _stream_sse(self, req: BaseHTTPRequestHandler, uid: int,
                    events: "queue.Queue", dequeue_once,
                    n_expected: int = 1) -> None:
        """One ``data:`` event per committed token (its branch in
        ``choices[0].index``), one finish event per branch, then ``[DONE]``
        once the ``n_expected`` branches finished. Keepalive comments
        between tokens probe for a vanished client; ~30 s of silence from a
        DEAD engine thread cancels with an error event (a live engine may
        be silent longer — a best-of family streams nothing until it joins
        — and its silence is bounded by deadline_s)."""
        if obs.REGISTRY.enabled:
            _HTTP_REQUESTS.labels(route="completions", code="200").inc()
        req.send_response(200)
        req.send_header("Content-Type", "text/event-stream")
        req.send_header("Cache-Control", "no-cache")
        req.end_headers()
        silent = 0
        finished = 0
        while True:
            try:
                kind, payload = events.get(timeout=self.keepalive_s)
            except queue.Empty:
                silent += 1
                if silent * self.keepalive_s >= _DEAD_ENGINE_S \
                        and not self._engine_alive():
                    self.engine.cancel(uid)
                    dequeue_once()
                    req.wfile.write(b"data: " + json.dumps({"error": {
                        "message": "engine unresponsive; request cancelled",
                        "type": "server_error"}}).encode() + b"\n\n")
                    req.wfile.write(b"data: [DONE]\n\n")
                    req.wfile.flush()
                    return
                # No token ready: probe the socket, so a vanished client is
                # found even while its request sits in prefill.
                req.wfile.write(b": keepalive\n\n")
                req.wfile.flush()
                continue
            silent = 0
            dequeue_once()
            idx, item = payload
            if kind == "token":
                req.wfile.write(_sse_token(uid, item, idx))
                req.wfile.flush()
                continue
            req.wfile.write(_sse_finish(uid, item, idx))
            if idx < n_expected:
                finished += 1
            if finished >= n_expected:
                req.wfile.write(b"data: [DONE]\n\n")
                req.wfile.flush()
                return
            req.wfile.flush()

    def _respond_whole(self, req: BaseHTTPRequestHandler, uid: int,
                       events: "queue.Queue", dequeue_once,
                       n_expected: int = 1) -> None:
        """``"stream": false``: wait for every expected branch's finish and
        answer one JSON body, its ``choices`` by index. 30 s of silence
        from a DEAD engine thread cancels with a 503; a live engine's
        silence only keeps the wait going."""
        finished: List[RequestResult] = []
        while len(finished) < n_expected:
            try:
                kind, payload = events.get(timeout=_DEAD_ENGINE_S)
            except queue.Empty:
                if self._engine_alive():
                    continue
                self.engine.cancel(uid)
                dequeue_once()
                self._reply_counted(
                    req, "completions", 503,
                    _error_json("engine unresponsive; request cancelled",
                                type="server_error"), "application/json")
                return
            # A generating request holds a slot, not the admission queue.
            dequeue_once()
            idx, item = payload
            if kind == "finish" and idx < n_expected:
                finished.append(item)
        finished.sort(key=lambda r: r.index)
        code = 200 if any(
            r.tokens or FINISH_REASONS.get(r.outcome, r.outcome)
            in ("stop", "length") for r in finished) else 503
        usage = _usage(finished[0])
        usage["completion_tokens"] = sum(len(r.tokens) for r in finished)
        # The request ledger rides the branch that closed it (the first to
        # retire on fork slots, the last on a token tree).
        ledger = next((r.ledger for r in finished if r.ledger is not None),
                      None)
        if ledger is not None:
            usage["ledger"] = ledger
        self._reply_counted(req, "completions", code, json.dumps({
            "id": f"cmpl-{uid}",
            "object": "text_completion",
            "choices": [{
                "index": r.index,
                "text": _render(r.tokens),
                "token_ids": list(r.tokens),
                "finish_reason": FINISH_REASONS.get(r.outcome, r.outcome),
            } for r in finished],
            "usage": usage,
        }, indent=2), "application/json")


# -- SSE wire helpers -------------------------------------------------------


def _render(tokens) -> str:
    """Token ids as text: space-separated ids (there is no tokenizer)."""
    return " ".join(str(int(t)) for t in tokens)


def _usage(result: RequestResult) -> Dict[str, Any]:
    usage: Dict[str, Any] = {
        "prompt_tokens": result.prompt_len,
        "completion_tokens": len(result.tokens),
        # How much of the prompt the prefix cache served (the fleet
        # router's feedback on its approximate trees).
        "prefix_hit_tokens": result.prefix_hit_tokens}
    if result.ledger is not None:
        # The finished request ledger: only while it is armed, and only on
        # the branch that closed it.
        usage["ledger"] = result.ledger
    return usage


def _sse_token(uid: int, tok: int, index: int = 0) -> bytes:
    return ("data: " + json.dumps({
        "id": f"cmpl-{uid}",
        "object": "text_completion",
        "choices": [{"index": index, "text": f"{int(tok)} ",
                     "token_ids": [int(tok)], "finish_reason": None}],
    }) + "\n\n").encode()


def _sse_finish(uid: int, result: RequestResult, index: int = 0) -> bytes:
    return ("data: " + json.dumps({
        "id": f"cmpl-{uid}",
        "object": "text_completion",
        "choices": [{"index": index, "text": "", "token_ids": [],
                     "finish_reason": FINISH_REASONS.get(result.outcome,
                                                         result.outcome)}],
        "usage": _usage(result),
    }) + "\n\n").encode()


def _error_json(message: str, type: str = "invalid_request") -> str:
    return json.dumps({"error": {"message": message, "type": type}},
                      indent=2)


def install_drain_signals(server: IngressServer) -> None:
    """SIGTERM/SIGINT -> graceful drain (main thread only: Python installs
    signal handlers there alone). The drain lets in-flight requests finish
    and the engine loop return, so the process exits through its normal
    telemetry flush. A second signal while draining falls back to the
    previous handler (an operator's double SIGTERM still kills a stuck
    drain)."""
    import os
    import signal

    prev = {}

    def _begin_drain(signum, frame):
        if server.draining:
            handler = prev.get(signum)
            if callable(handler):
                handler(signum, frame)
            else:
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)
            return
        server.drain()

    for sig in (signal.SIGTERM, signal.SIGINT):
        prev[sig] = signal.signal(sig, _begin_drain)
