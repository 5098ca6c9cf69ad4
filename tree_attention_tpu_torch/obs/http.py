"""Live telemetry HTTP endpoint: /metrics, /healthz, /flight, /requests.

Counterpart of ``tree_attention_tpu/obs/http.py``. A stdlib server on a
daemon thread (``utils/httpd.py``'s :class:`DaemonHTTPServer`, the
ingress's base too) serving:

- ``/metrics``: Prometheus text exposition format,
  :meth:`MetricsRegistry.to_prometheus` at scrape time;
- ``/metrics.json``: the registry snapshot (what ``--metrics-out``
  writes at exit, live);
- ``/healthz``: tick liveness from the flight recorder
  (:func:`flight_health`): 200 while the engine records ticks or is idle,
  503 once the last tick is older than ``stall_after``, so a wedged tick
  loop fails the check though the HTTP thread still answers;
- ``/flight``: the flight recorder's ring as JSON;
- ``/requests``: the request ledger (``{"enabled", "live", "recent"}``:
  live requests with their running wall segments, and the bounded ring of
  finished ones);
- ``/request/{uid}``: one request's ledger, live or recent, with its
  phase timeline; 404 for a uid never seen or evicted from the ring, 400
  for one that is not an integer;
- ``/slots``: per-slot occupancy of the attached engine
  (``slots_snapshot``); 404 until one is attached;
- ``/``: the index of these routes.

A scrape holds the registry's lock for one snapshot and reads the engine
through its GIL-atomic ``slots_snapshot``, never a lock the tick loop
holds; nothing here touches the device.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, Optional, Tuple

from tree_attention_tpu_torch.obs.flight import FLIGHT, FlightRecorder
from tree_attention_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from tree_attention_tpu_torch.obs.reqlog import REQLOG, ReqLog
from tree_attention_tpu_torch.utils.httpd import DaemonHTTPServer

DEFAULT_STALL_AFTER = 60.0


def flight_health(flight: FlightRecorder,
                  stall_after: float = DEFAULT_STALL_AFTER,
                  ) -> Tuple[int, Dict[str, Any]]:
    """The tick-liveness verdict over one flight recorder: 200 ``idle``
    before any tick or once the loop said it drained (``mark_idle``), 200
    ``ok`` while the last tick is at most ``stall_after`` seconds old, 503
    ``stalled`` past it."""
    age = flight.last_tick_age()
    body: Dict[str, Any] = {
        "ticks_recorded": flight.ticks_recorded,
        "last_tick_age_s": None if age is None else round(age, 3),
        "stall_after_s": stall_after,
    }
    if age is None or flight.idle:
        # Alive between runs however old the last tick: only a loop that
        # stopped without draining stalls.
        body["status"] = "idle"
        return 200, body
    if age <= stall_after:
        body["status"] = "ok"
        return 200, body
    body["status"] = "stalled"
    return 503, body


class MetricsHTTPServer(DaemonHTTPServer):
    """Daemon-thread HTTP exporter over one registry, flight recorder and
    request ledger (``reqlog``, backing ``/requests`` and
    ``/request/{uid}``).

    ``engine`` (optional) is anything with a ``slots_snapshot()`` method, a
    :class:`SlotServer` or a :class:`DisaggServer`, backing ``/slots``."""

    thread_name = "obs-http"

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        *,
        registry: MetricsRegistry = REGISTRY,
        flight: FlightRecorder = FLIGHT,
        reqlog: ReqLog = REQLOG,
        engine: Optional[Any] = None,
        stall_after: float = DEFAULT_STALL_AFTER,
    ):
        super().__init__(port, host)
        self._registry = registry
        self._flight = flight
        self._reqlog = reqlog
        self._engine = engine
        self._stall_after = stall_after

    def attach_engine(self, engine: Any) -> None:
        """Wire the engine behind ``/slots`` after the start (the CLI
        starts the exporter before it builds the engine; a scrape before
        this answers 404)."""
        self._engine = engine

    # -- endpoints --------------------------------------------------------

    def handle(self, method: str, req: BaseHTTPRequestHandler) -> None:
        if method != "GET":
            # Read the body first: a reply before it can reset the socket
            # under the client's write (as the ingress found).
            n = req.headers.get("Content-Length", "0")
            if n.isdigit() and int(n) > 0:
                req.rfile.read(int(n))
            self.reply(req, 405, "metrics endpoint is read-only\n",
                       "text/plain")
            return
        path = req.path.split("?", 1)[0].rstrip("/") or "/"
        if path == "/metrics":
            self.reply(
                req, 200, self._registry.to_prometheus(),
                "text/plain; version=0.0.4; charset=utf-8",
            )
        elif path == "/metrics.json":
            self.reply(req, 200, self._registry.to_json(indent=2),
                       "application/json")
        elif path == "/healthz":
            code, body = flight_health(self._flight, self._stall_after)
            self.reply(req, code, json.dumps(body, indent=2),
                       "application/json")
        elif path == "/flight":
            self.reply(
                req, 200,
                json.dumps(self._flight.snapshot(), indent=2, default=str),
                "application/json",
            )
        elif path == "/requests":
            self.reply(req, 200,
                       json.dumps(self._reqlog.snapshot(), indent=2),
                       "application/json")
        elif path.startswith("/request/"):
            self._request_detail(req, path[len("/request/"):])
        elif path == "/slots":
            engine = self._engine
            if engine is None:
                self.reply(req, 404, "no engine wired into this exporter\n",
                           "text/plain")
            else:
                self.reply(req, 200,
                           json.dumps(engine.slots_snapshot(), indent=2),
                           "application/json")
        elif path == "/":
            self.reply(
                req, 200,
                "tree_attention_tpu_torch telemetry: /metrics /metrics.json "
                "/healthz /flight /requests /request/{uid} /slots\n",
                "text/plain",
            )
        else:
            self.reply(req, 404, f"no such endpoint: {path}\n",
                       "text/plain")

    def _request_detail(self, req: BaseHTTPRequestHandler,
                        tail: str) -> None:
        try:
            uid = int(tail)
        except ValueError:
            self.reply(req, 400, f"uid must be an integer, got {tail!r}\n",
                       "text/plain")
            return
        ledger = self._reqlog.get(uid)
        if ledger is None:
            self.reply(req, 404,
                       f"no ledger for request {uid} (never seen, or "
                       f"evicted from the recent ring)\n", "text/plain")
            return
        self.reply(req, 200, json.dumps(ledger, indent=2),
                   "application/json")
