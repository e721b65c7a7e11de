"""Minimal HTTP serving frontend (stdlib only).

POST /synthesize   body = .npy bytes of a float mel (T, C)
                   -> 200, .npy bytes of the float32 waveform (T * hop,)
GET  /healthz      -> 200, JSON {status, model, requests_served, batches_run,
                   mesh_size}

Concurrent POSTs ride a ThreadingHTTPServer into the `DynamicBatcher`, so
simultaneous requests synthesize as one batch on the GPU.  This is a
reference serving frontend, not a production web stack: no auth, no TLS —
front it with a real ingress for deployment.

Run: `python -m fastvocoder_tpu_torch.bin.serve --checkpoint_path <npz>
--model_name basis-melgan --config <yaml> [--port N]`.  The port's copy of
`fastvocoder_tpu/serving/server.py`.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

import numpy as np

from fastvocoder_tpu_torch.serving.batcher import DynamicBatcher, QueueFull

MAX_BODY = 256 * 1024 * 1024  # npy mels are small; reject absurd payloads


def _handler_class(
    batcher: DynamicBatcher, input_channels: int, model_name: str,
    validate=None, mesh_size: int = 1,
):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet; healthz polls are noisy
            pass

        def _reply(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code: int, obj):
            self._reply(
                code, json.dumps(obj).encode(), "application/json"
            )

        def do_GET(self):
            if self.path != "/healthz":
                return self._reply_json(404, {"error": "unknown path"})
            self._reply_json(
                200,
                {"status": "ok", "model": model_name, **batcher.stats(),
                 "mesh_size": mesh_size},
            )

        def do_POST(self):
            if self.path != "/synthesize":
                return self._reply_json(404, {"error": "unknown path"})
            n = int(self.headers.get("Content-Length", 0))
            if not 0 < n <= MAX_BODY:
                return self._reply_json(400, {"error": "bad Content-Length"})
            body = self.rfile.read(n)
            try:
                mel = np.load(io.BytesIO(body), allow_pickle=False)
            except Exception as e:
                return self._reply_json(400, {"error": f"not a .npy mel: {e}"})
            if mel.ndim != 2 or mel.shape[1] != input_channels or mel.shape[0] < 1:
                return self._reply_json(
                    400,
                    {
                        "error": f"expected (T >= 1, {input_channels}) mel, "
                        f"got {list(mel.shape)}"
                    },
                )
            if validate is not None:
                try:
                    # per-request checks (e.g. basis pattern coverage)
                    # BEFORE coalescing: one bad request must not poison
                    # every Future batched with it
                    validate(mel)
                except ValueError as e:
                    return self._reply_json(400, {"error": str(e)})
            try:
                wav = batcher.submit(mel.astype(np.float32)).result()
            except QueueFull as e:  # backpressure: shed load, retry later
                return self._reply_json(503, {"error": str(e)})
            except Exception as e:
                return self._reply_json(500, {"error": str(e)})
            buf = io.BytesIO()
            np.save(buf, np.asarray(wav, np.float32))
            self._reply(200, buf.getvalue(), "application/octet-stream")

    return Handler


def make_server(
    synthesize: Callable,
    input_channels: int = 80,
    model_name: str = "unknown",
    host: str = "127.0.0.1",
    port: int = 8571,
    max_batch: int = 32,
    max_wait_ms: float = 5.0,
    max_pending: int = 1024,
    validate=None,
    mesh_size: int = 1,
):
    """-> (ThreadingHTTPServer, DynamicBatcher).  `synthesize` is any
    list[mel]->list[wav] callable (ServingModel, BatchedSynthesizer, or a
    test stub).  `validate(mel)` (e.g. ServingModel.validate) runs per
    request before coalescing; its ValueError maps to HTTP 400.  Caller
    owns serve_forever/shutdown and batcher.close().  `mesh_size`, the
    devices `synthesize` splits a batch over, is reported by /healthz."""
    batcher = DynamicBatcher(
        synthesize,
        max_batch=max_batch,
        max_wait_ms=max_wait_ms,
        max_pending=max_pending,
    )
    httpd = ThreadingHTTPServer(
        (host, port),
        _handler_class(batcher, input_channels, model_name, validate=validate,
                       mesh_size=mesh_size),
    )
    return httpd, batcher


def run_server(httpd, batcher) -> threading.Thread:
    """serve_forever on a daemon thread; returns the thread.  Stop with
    httpd.shutdown(); batcher.close()."""
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return t
