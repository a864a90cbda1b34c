"""The ``/metrics``, ``/varz`` and ``/healthz`` exporter: one stdlib HTTP
thread over a registry.

Port of ``ape_x_dqn_tpu/obs/exporter.py`` (``ObsServer``, :38):

  * ``/metrics`` — the registry's Prometheus text;
  * ``/varz``    — the registry's JSON snapshot (what ``tools/obs_top.py
    --varz`` reads); ``?trace=1`` (and ``&steps=N``) also fires the trace
    hook (``obs/trace.TraceOnDemand``) and returns its status under
    ``trace``;
  * ``/healthz`` — the ``Health`` status, 200 when every component is ok,
    503 when one is degraded.

Port 0 binds an ephemeral port (``ObsServer.port``); the default host is
the loopback: an operator surface, not a public one.  The runtime
(``runtime/async_pipeline.py``) and ``serve --obs-port`` mount one.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

from ape_x_dqn_tpu_torch.obs.registry import Health, MetricsRegistry


class ObsServer:
    """One exporter thread over a registry, an optional ``Health`` and an
    optional trace hook.  ``close()`` shuts the socket down; the thread is a
    daemon, so a crashed host process never hangs on it."""

    def __init__(self, registry: MetricsRegistry, health: Optional[Health] = None,
                 port: int = 0, host: str = "127.0.0.1",
                 trace_hook: Optional[Callable[..., dict]] = None):
        self.registry = registry
        self.health = health
        self._trace_hook = trace_hook
        obs = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # noqa: N802 — http.server API
                pass  # scrapes must not write to the run's streams

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — http.server API
                try:
                    url = urlparse(self.path)
                    if url.path == "/metrics":
                        body = obs.registry.prometheus_text().encode()
                        self._reply(200, body, "text/plain; version=0.0.4")
                    elif url.path == "/varz":
                        snap = obs.registry.snapshot()
                        q = parse_qs(url.query)
                        if q.get("trace", ["0"])[0] not in ("0", ""):
                            snap["trace"] = obs.trigger_trace(
                                steps=int(q["steps"][0]) if "steps" in q else None)
                        body = json.dumps(snap, default=str).encode()
                        self._reply(200, body, "application/json")
                    elif url.path == "/healthz":
                        st = ({"status": "ok", "components": {}} if obs.health is None
                              else obs.health.status())
                        code = 200 if st["status"] == "ok" else 503
                        self._reply(code, json.dumps(st).encode(), "application/json")
                    else:
                        self._reply(404, b"not found\n", "text/plain")
                except BrokenPipeError:
                    pass  # the scraper went away mid-reply
                except Exception as e:  # noqa: BLE001 — always reply
                    try:
                        self._reply(500, f"{type(e).__name__}: {e}\n".encode(),
                                    "text/plain")
                    except OSError:
                        pass

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="obs-exporter", daemon=True)
        self._thread.start()

    def trigger_trace(self, steps: Optional[int] = None) -> dict:
        if self._trace_hook is None:
            return {"state": "unavailable", "reason": "no trace hook attached"}
        try:
            return self._trace_hook(steps=steps)
        except Exception as e:  # noqa: BLE001 — a scrape must not crash
            return {"state": "error", "reason": f"{type(e).__name__}: {e}"}

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
