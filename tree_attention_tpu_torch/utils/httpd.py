"""Stdlib HTTP plumbing: a daemon-thread server with a subclass hook.

Counterpart of ``tree_attention_tpu/utils/httpd.py`` (the port's own copy):

- :class:`DaemonHTTPServer` — bind/start/stop/port lifecycle plus the
  length-framed :meth:`reply` helper, on the stdlib
  :class:`~http.server.ThreadingHTTPServer` (no new dependency), bound to
  localhost unless a caller exposes it, ``port=0`` letting the OS pick.
  Subclasses implement :meth:`handle` (method + path routing); a vanished
  client's ``BrokenPipeError`` / ``ConnectionResetError`` is swallowed
  here, once.
- Handlers run on per-connection daemon threads, so a slow or stuck client
  can never block :meth:`stop` or the process's exit.
- The listen backlog holds a burst of connections (the stdlib's is 5): a
  connection past a full backlog is dropped and the client's kernel sends
  it again only after ~1 s, which a client reads as a second of latency.

Streaming responses (the ingress's SSE token feed) bypass :meth:`reply`
and write the handler's ``wfile`` directly; the server stays HTTP/1.0
(close-delimited bodies), so a stream ends when the handler returns and
the connection closes.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class _ThreadingServer(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 128


class DaemonHTTPServer:
    """Daemon-thread HTTP server lifecycle over a subclass :meth:`handle`.

    Bind: localhost by default (none of this repo's HTTP surfaces are
    open services); pass ``host="0.0.0.0"`` explicitly to expose one.
    ``port=0`` lets the OS pick — :attr:`port` reports the bound port
    after :meth:`start`.
    """

    #: Thread name for the accept loop (subclasses override for ps/py-spy
    #: readability).
    thread_name = "httpd"

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._host = host
        self._want_port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle --------------------------------------------------------

    def start(self) -> int:
        """Bind and serve on a daemon thread; returns the bound port.
        Idempotent — a second call returns the existing port."""
        if self._httpd is not None:
            return self.port
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # no stderr per request
                pass

            def _dispatch(self, method: str) -> None:
                try:
                    server.handle(method, self)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client went away mid-reply

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

        self._httpd = _ThreadingServer((self._host, self._want_port),
                                       Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=self.thread_name,
            daemon=True,
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._thread = None

    @property
    def port(self) -> int:
        return 0 if self._httpd is None else self._httpd.server_address[1]

    @property
    def running(self) -> bool:
        return self._httpd is not None

    # -- routing (subclass hook) ------------------------------------------

    def handle(self, method: str, req: BaseHTTPRequestHandler) -> None:
        """Route one request; the default is a 404 for everything."""
        self.reply(req, 404, f"no such endpoint: {req.path}\n", "text/plain")

    # -- reply helper ------------------------------------------------------

    @staticmethod
    def reply(req: BaseHTTPRequestHandler, code: int, body: str,
              ctype: str, headers: Optional[dict] = None) -> None:
        """One complete, length-framed response."""
        data = body.encode("utf-8")
        req.send_response(code)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            req.send_header(k, str(v))
        req.end_headers()
        req.wfile.write(data)
