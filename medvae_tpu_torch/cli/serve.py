"""`serve` entry point — HTTP inference server over a port checkpoint
(counterpart of medvae_tpu/cli/serve.py).

Endpoints (JSON):
  GET  /healthz      -> {"status": "ok"}
  GET  /info         -> model family, resolution, buckets, modalities
  POST /reconstruct  {"images_b64": <b64 .npy NHWC uint8>[, "modality": ...,
                      "output": "float32"|"uint8"]}
                     -> {"images_b64": <b64 .npy float32 [-1,1] or uint8>}
                     (or {"images": nested lists} both ways)
  POST /encode       same request -> {"mean_b64", "logvar_b64"}
  POST /sample       {"num_samples": N[, "modality": ..., "seed": S,
                      "output": ...]} -> {"images_b64"}

`modality` may be a dataset name ("chestmnist"), an index, or a per-sample
index list. Arrays ride base64-encoded .npy for exactness.

    python -m medvae_tpu_torch.cli.serve --model_path model.pt [--device cuda]
"""

from __future__ import annotations

import argparse
import base64
import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def _np_to_b64(a: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(a))
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _b64_to_np(s: str) -> np.ndarray:
    return np.load(io.BytesIO(base64.b64decode(s)), allow_pickle=False)


def _request_images(payload: dict) -> np.ndarray:
    if "images_b64" in payload:
        return _b64_to_np(payload["images_b64"])
    if "images" in payload:
        return np.asarray(payload["images"])
    raise ValueError("request needs 'images_b64' or 'images'")


def _request_modality(payload: dict):
    m = payload.get("modality")
    if isinstance(m, list):
        return np.asarray(m, np.int32)
    if isinstance(m, int):
        return np.asarray([m], np.int32)
    return m  # str or None


def make_handler(engine):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok"})
            elif self.path == "/info":
                self._send(200, engine.info())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                output = str(payload.get("output", "float32"))
                if self.path == "/reconstruct":
                    out = engine.reconstruct(
                        _request_images(payload), _request_modality(payload), output=output
                    )
                    self._send(200, {"images_b64": _np_to_b64(out)})
                elif self.path == "/encode":
                    mean, logvar = engine.encode(
                        _request_images(payload), _request_modality(payload)
                    )
                    self._send(
                        200, {"mean_b64": _np_to_b64(mean), "logvar_b64": _np_to_b64(logvar)}
                    )
                elif self.path == "/sample":
                    out = engine.sample(
                        int(payload.get("num_samples", 16)), _request_modality(payload),
                        seed=payload.get("seed"), output=output,
                    )
                    self._send(200, {"images_b64": _np_to_b64(out)})
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})
            except Exception as e:  # surfaced to the client, the server stays up
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(engine, host: str = "127.0.0.1", port: int = 8901,
          warmup: bool = True) -> ThreadingHTTPServer:
    """Build (and return) the HTTP server; the caller runs serve_forever()."""
    if warmup:
        engine.warmup()
    return ThreadingHTTPServer((host, port), make_handler(engine))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Serve a port checkpoint over HTTP")
    p.add_argument("--model_path", required=True,
                   help="port checkpoint (.pt) or a trainer snapshot directory")
    p.add_argument("--device", default="cuda")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8901)
    p.add_argument("--buckets", default="1,8,32,128")
    p.add_argument("--no_warmup", action="store_true")
    p.add_argument("--use_ema", action="store_true",
                   help="serve the EMA weight average from the checkpoint")
    p.add_argument("--mesh", action="store_true",
                   help="shard request batches over all of this node's cards")
    args = p.parse_args(argv)

    from medvae_tpu_torch.serve.engine import InferenceEngine

    engine = InferenceEngine.from_checkpoint(
        args.model_path, buckets=[int(b) for b in args.buckets.split(",")],
        device=args.device, use_ema=args.use_ema, mesh=args.mesh,
    )
    httpd = serve(engine, args.host, args.port, warmup=not args.no_warmup)
    print(f"serving {engine.info()['model']} on http://{args.host}:{args.port}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
