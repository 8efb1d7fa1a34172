"""Stdlib HTTP front end for the micro-batcher (a copy of
``video_spike_tpu/serve/http.py``).

Endpoints:
- ``POST /predict`` — body is a ``.npy`` payload (``np.save`` bytes) of one
  sample or a batch; optional ``X-Session-Id`` header for multi-session
  models. Response is ``.npy`` bytes of the predicted log-rates.
- ``GET /healthz`` — 200 once the model is loaded.
- ``GET /stats`` — JSON latency/batching counters.

No third-party server dependency: ThreadingHTTPServer handles concurrent
clients, whose requests coalesce in the MicroBatcher into single device
dispatches.
"""

from __future__ import annotations

import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def _make_handler(batcher):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):   # quiet; /stats reports instead
            pass

        def _send(self, code: int, body: bytes,
                  ctype: str = "application/octet-stream") -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, b"ok", "text/plain")
            elif self.path == "/stats":
                self._send(200, json.dumps(batcher.stats()).encode(),
                           "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, b"not found", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                arr = np.load(io.BytesIO(self.rfile.read(n)),
                              allow_pickle=False)
                sid = self.headers.get("X-Session-Id")
                sid = int(sid) if sid is not None else None
                sample_ndim = getattr(batcher, "sample_ndim", None)
                # trust an explicit header even for a batch of one row —
                # that row still needs its leading dim stripped
                batched = (self.headers.get("X-Batched") == "1"
                           and arr.ndim >= 1 and arr.shape[0] >= 1)
                # a multi-row payload without the header would reach the
                # model with an extra leading dim and die with an opaque
                # shape error deep inside the forward — fan it out instead
                if (not batched and sample_ndim is not None
                        and arr.ndim == sample_ndim + 1):
                    batched = True
                if batched:
                    futs = [batcher.submit(row, sid) for row in arr]
                    out = np.stack([f.result(timeout=60) for f in futs])
                else:
                    out = batcher.submit(arr, sid).result(timeout=60)
                buf = io.BytesIO()
                np.save(buf, np.asarray(out))
                self._send(200, buf.getvalue())
            except Exception as e:
                self._send(400, str(e).encode(), "text/plain")

    return Handler


def serve_http(batcher, port: int = 8000, host: str = "0.0.0.0",
               block: bool = True) -> ThreadingHTTPServer:
    """Start the server; with ``block=False`` returns it for the caller to
    drive (tests run it on a daemon thread and shut it down)."""
    server = ThreadingHTTPServer((host, port), _make_handler(batcher))
    if block:
        server.serve_forever()
    return server
