"""Serving shim for the ProtoSAM pipeline (JAX ``protosam_tpu/serve.py``).

One-shot segmentation as a service: the support set is registered once
(per organ or task), its features encoded once, then queries stream
through the pipeline.  The wire format is raw numpy payloads:

  POST /register_support   body: npz{images (S, 3, H, W), masks (S, H, W)}
  POST /segment            body: npy (3, H, W) or (N, 3, H, W) -> npy mask(s)
  GET  /healthz            -> {"status", "device", "device_name",
                               "support_registered"}

Usage:  python3 -m protosam_tpu_torch.serve with modelname=dinov2_l14 ...
port=8000 (the pipeline of ``build_models(cfg)``, on the card).

``ThreadingHTTPServer`` answers each request in a thread of its own, and
torch's grad mode is thread-local, so every request runs under
``torch.inference_mode()``: the pipeline's own ``no_grad`` does not reach
a support encoded at registration, where the kernels' autograd wrappers
would otherwise record graphs.
"""

from __future__ import annotations

import io
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from protosam_tpu_torch.models.io_protocol import ALPNetInput

log = logging.getLogger("serve")


class PipelineService:
    """The pipeline and the registered support; one request at a time
    reaches the pipeline."""

    def __init__(self, pipe, val_wsize: int = 2, slice_batch: int = 4):
        self.pipe = pipe
        self.val_wsize = val_wsize
        self.slice_batch = slice_batch
        self.lock = threading.Lock()
        self.inp = None

    @property
    def device(self) -> torch.device:
        return next(self.pipe.coarse_model.parameters()).device

    def register_support(self, images: np.ndarray, masks: np.ndarray):
        dev = self.device
        with self.lock, torch.inference_mode():
            inp = ALPNetInput(torch.as_tensor(images).to(dev),
                              torch.as_tensor(masks).to(dev),
                              torch.as_tensor(images[:1]).to(dev),
                              isval=True, val_wsize=self.val_wsize)
            # the support's features, encoded once for every query
            inp.supp_fts = self.pipe.coarse_model.get_features(inp.supp_imgs)
            self.inp = inp

    def segment(self, query: np.ndarray) -> np.ndarray:
        if self.inp is None:
            raise RuntimeError("no support set registered")
        q = torch.as_tensor(np.asarray(query, np.float32)).to(self.device)
        with self.lock, torch.inference_mode():
            if q.ndim == 3:
                pred, _ = self.pipe.forward(q[None], self.inp)
            else:
                pred, _ = self.pipe.forward_volume(
                    q, self.inp, slice_batch=self.slice_batch)
            return pred.cpu().numpy()


def make_handler(service: PipelineService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body, ctype="application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            log.debug(fmt, *args)

        def do_GET(self):
            if self.path == "/healthz":
                dev = service.device
                name = (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu")
                body = json.dumps({
                    "status": "ok",
                    "device": str(dev),
                    "device_name": name,
                    "support_registered": service.inp is not None,
                }).encode()
                self._send(200, body, "application/json")
            else:
                self._send(404, b"not found")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(n)
            try:
                if self.path == "/register_support":
                    npz = np.load(io.BytesIO(data))
                    service.register_support(npz["images"], npz["masks"])
                    self._send(200, json.dumps({"status": "ok"}).encode(),
                               "application/json")
                elif self.path == "/segment":
                    arr = np.load(io.BytesIO(data))
                    out = service.segment(arr)
                    buf = io.BytesIO()
                    np.save(buf, out)
                    self._send(200, buf.getvalue())
                else:
                    self._send(404, b"not found")
            except Exception as e:  # noqa: BLE001 (reported to the client)
                log.exception("request failed")
                self._send(400, json.dumps({"error": str(e)}).encode(),
                           "application/json")

    return Handler


def serve(pipe, host: str = "0.0.0.0", port: int = 8000, **kwargs
          ) -> ThreadingHTTPServer:
    """An HTTP server for ``pipe`` (not yet serving: call
    ``serve_forever``); ``kwargs`` go to ``PipelineService``."""
    service = PipelineService(pipe, **kwargs)
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    httpd.service = service
    return httpd


def main(argv=None):
    import sys

    from protosam_tpu_torch.eval.protosam_eval import build_models
    from protosam_tpu_torch.utils.config import load_config, parse_overrides

    logging.basicConfig(level=logging.INFO)
    argv = argv if argv is not None else sys.argv[1:]
    cfg = load_config(argv)
    port = int(parse_overrides(argv).get("port", 8000) or 8000)
    pipe = build_models(cfg)
    httpd = serve(pipe, port=port, val_wsize=cfg.val_wsize,
                  slice_batch=cfg.slice_batch)
    log.info("serving on :%d", httpd.server_address[1])
    httpd.serve_forever()


if __name__ == "__main__":
    main()
