#!/usr/bin/env python
"""Minimal HTTP inference server over a ``torch.export`` artifact of the
PyTorch port.

Counterpart of ``tools/serve.py``: load the artifact that
``tools/export_torch.py`` wrote (``torch.export.load``; no model code is
imported, only K2's custom ops, for an artifact of a ``network.pallas_conv``
net), preprocess with its metadata's normalize constants, run it on
the device it was exported for, and return argmax label maps.

    python tools/serve_torch.py --artifact model_artifacts/w48 --port 8901

    # client: a .npy array
    curl -s -X POST --data-binary @frame.npy \\
        -H 'Content-Type: application/x-npy' \\
        http://localhost:8901/segment -o labels.npy

Endpoints:
    GET  /healthz   -> {"status": "ok", ...metadata}
    POST /segment   -> .npy int32 [H, W] train-id label map
                       (body: .npy uint8/float32 [H, W, 3] RGB image;
                       resized server-side to the artifact's input size
                       with the port's bicubic, ``native/segdata.cpp``,
                       labels returned at artifact size)

The server is stdlib-only (``http.server``); the point is the artifact
contract, not a web framework.  It serves from one device: under
``torchrun`` at world size > 1 it raises.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import threading

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class ArtifactRunner:
    """Load once, serve concurrently (calls into the module are serialised)."""

    def __init__(self, artifact: str):
        from tools.export_torch import load_artifact

        self.module, self.meta = load_artifact(artifact)
        self.device = self.meta["device"]
        shape = self.meta["input"]["shape"]
        self.batch = None if isinstance(shape[0], str) else int(shape[0])
        self.h, self.w = int(shape[1]), int(shape[2])
        nz = self.meta["normalize"]
        self.div = float(nz["div_value"])
        self.mean = np.asarray(nz["mean"], np.float32)
        self.std = np.asarray(nz["std"], np.float32)
        self._lock = threading.Lock()

    def preprocess(self, img: np.ndarray) -> np.ndarray:
        if img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"expected [H, W, 3] RGB, got {img.shape}")
        if img.shape[:2] != (self.h, self.w):
            from contrastiveseg_tpu_torch.data import native

            img = native.resize_bicubic_u8(
                np.ascontiguousarray(np.clip(img, 0, 255).astype(np.uint8)), (self.w, self.h))
            if img is None:
                raise RuntimeError("the segdata library (native/segdata.cpp) is not "
                                   f"available: {native.LIBRARY.route()}")
        x = img.astype(np.float32) / self.div
        return ((x - self.mean) / self.std)[None]

    def segment(self, img: np.ndarray) -> np.ndarray:
        import torch

        x = torch.from_numpy(self.preprocess(img))
        if self.batch is not None and self.batch != 1:
            x = x.repeat(self.batch, 1, 1, 1)
        with self._lock, torch.no_grad():  # one device: serialise the calls
            logits = self.module(x.to(self.device))
            labels = logits[0].argmax(-1).to(torch.int32).cpu().numpy()
        return labels


def make_handler(runner: ArtifactRunner):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                body = json.dumps({"status": "ok", **runner.meta}).encode()
                self._send(200, body, "application/json")
            else:
                self._send(404, b"{}", "application/json")

        def do_POST(self):
            if self.path != "/segment":
                self._send(404, b"{}", "application/json")
                return
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n)
            try:
                img = np.load(io.BytesIO(raw), allow_pickle=False)
                labels = runner.segment(np.asarray(img))
            except (ValueError, RuntimeError, EOFError, OSError) as e:  # a bad body or image
                self._send(400, json.dumps({"error": str(e)}).encode(), "application/json")
                return
            buf = io.BytesIO()
            np.save(buf, labels)
            self._send(200, buf.getvalue(), "application/x-npy")

    return Handler


def make_server(artifact: str, port: int, host: str = "127.0.0.1"):
    """A ``ThreadingHTTPServer`` over the artifact; the caller runs
    ``serve_forever`` and, to stop, ``shutdown`` and ``server_close``."""
    from http.server import ThreadingHTTPServer

    return ThreadingHTTPServer((host, port), make_handler(ArtifactRunner(artifact)))


def main():
    from contrastiveseg_tpu_torch.parallel import require_one_process

    require_one_process("tools/serve_torch.py")
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--artifact", required=True,
                    help="path prefix from tools/export_torch.py --out")
    ap.add_argument("--port", type=int, default=8901)
    args = ap.parse_args()
    httpd = make_server(args.artifact, args.port)
    print(f"serving {args.artifact} on http://127.0.0.1:{httpd.server_address[1]}")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
