"""Minimal HTTP inference server over the port's serving artifact
(counterpart of ``gan_ffn_tpu/cli/serve.py``, the same API).

    python -m gan_ffn_tpu_torch.cli.serve --artifact gan_ffn.pt --port 8000

API (JSON over HTTP):
- ``GET /healthz`` -> ``{"status": "ok", "model": ..., "family": ...,
  "inputs": [...], "buckets": [...], ...}``
- ``POST /predict`` with ``audio``/``visual``/``text`` as nested (L, B, D)
  lists plus optional ``valid_len`` -> ``{"classes": [[...]],
  "class_names": [[...]]}`` with per-dialogue rows (length-B lists of
  length-L lists).

``--batch-grid 1,4,8,32`` pads a request's batch up to the next grid size
instead of the artifact's batch size, so small requests run small batches.
``--warmup`` runs one request per grid shape before accepting connections
(it builds the CUDA kernels on first use).  ``--device`` defaults to cuda.
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..serving import ServingClassifier


def make_handler(clf: ServingClassifier):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {
                    "status": "ok",
                    "model": clf.meta.get("model"),
                    "family": clf.family,
                    "inputs": list(clf.input_names),
                    "buckets": list(clf.buckets),
                    "batch_size": clf.batch_size,
                    "batch_grid": list(clf.batch_grid) if clf.batch_grid else None,
                    "label_names": list(clf.label_names),
                    "dtype": clf.dtype,
                    "weights": clf.weights,
                    "device": str(clf.device),
                })
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length).decode("utf-8"))
                tensors = [
                    np.asarray(req[name], np.float32) for name in clf.input_names
                ]
                ids = clf.predict(*tensors, valid_len=req.get("valid_len"))
                self._send(200, {
                    "classes": ids.T.tolist(),  # per-dialogue rows
                    "class_names": clf.names_for(ids),
                })
            except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
                # TypeError covers valid-JSON-wrong-shape bodies (a top-level
                # array, a dict as a tensor value): 400, not a dead handler
                self._send(400, {"error": str(e)})

        def log_message(self, fmt, *a):  # quiet by default; errors still raise
            pass

    return Handler


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Serve a GAN_FFN artifact over HTTP")
    p.add_argument("--artifact", default="gan_ffn.pt")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda",
                   help="torch device the model runs on (default cuda)")
    p.add_argument("--batch-grid", default=None, metavar="B1,B2,...",
                   help="latency policy: pad request batch up to the next "
                        "grid size (e.g. 1,4,8,32) instead of the training "
                        "batch size")
    p.add_argument("--warmup", action="store_true", default=False,
                   help="run one request per grid shape before accepting "
                        "connections")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    grid = [int(b) for b in args.batch_grid.split(",")] if args.batch_grid else None
    clf = ServingClassifier.load(args.artifact, device=args.device, batch_grid=grid)
    if args.warmup:
        for L, B, secs in clf.warmup():
            print(f"warmup L={L} B={B}: {secs:.2f}s")
    server = ThreadingHTTPServer((args.host, args.port), make_handler(clf))
    print(f"serving {args.artifact} ({clf.meta.get('model')} on {clf.device}, "
          f"buckets {list(clf.buckets)}) on http://{args.host}:{server.server_port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
