"""Dependency-free threaded HTTP serving for the VisCoIN ensemble.

Counterpart of ``viscoin_tpu/serve/server.py``. Endpoints (JSON in -> JSON
out unless noted):

  * ``GET  /healthz``          liveness + model config
  * ``GET  /v1/stats``         per-endpoint micro-batching statistics
  * ``POST /v1/classify``      images -> predictions + top-k probas + top
                               concept activations
  * ``POST /v1/reconstruct``   images -> npz {reconstruction_u8, preds, expl_preds}
  * ``POST /v1/amplify``       one image -> npz {amplified_u8, probas_best,
                               probas_rand, default_probas, multipliers};
                               query: multipliers (default "0,1,2,4"), and
                               top_k_concepts, indices or threshold (default
                               0.2) to select concepts, seed
  * ``POST /v1/explain``       images -> npz {heatmap_conv1..5 (B, h, w)
                               GradCAM maps of Psi's convs at the explainer's
                               predicted class, preds, expl_preds,
                               top_concepts, top_concept_activations};
                               query: top_k

Amplify is served directly (it already batches its variants on the device),
one request at a time. The engine is an ``InferenceEngine`` or a sealed
artifact's ``ExportedEngine`` (``serve/export.py``), which has no amplify
and may lack explain: both answer 400 there. Request bodies: ``.npz`` bytes with an ``images`` array ((H,W,3) or
(N,H,W,3) uint8), a raw PNG/JPEG (content-type ``image/*``), or JSON
``{"images": nested-lists}``. Arbitrary sizes are resized on the host with
the eval geometry (engine.prepare_image). Each request image goes through a
:class:`MicroBatcher` per endpoint, so concurrent clients share device
batches.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl, urlparse

import numpy as np

from viscoin_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from viscoin_tpu_torch.serve.batching import MicroBatcher


class RequestError(ValueError):
    """Client error -> HTTP 400."""


def _decode_images(body: bytes, content_type: str) -> np.ndarray:
    """Request body -> (N, H, W, 3) uint8."""
    ct = (content_type or "").split(";")[0].strip().lower()
    if ct.startswith("image/"):
        from PIL import Image

        try:
            img = Image.open(io.BytesIO(body)).convert("RGB")
        except Exception as e:
            raise RequestError(f"undecodable image body: {e}")
        arr = np.asarray(img, np.uint8)[None]
    elif ct == "application/json":
        try:
            payload = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise RequestError(f"invalid JSON body: {e}")
        if "images" not in payload:
            raise RequestError('JSON body must contain "images"')
        arr = np.asarray(payload["images"])
    else:  # default: npz
        try:
            data = np.load(io.BytesIO(body), allow_pickle=False)
        except Exception as e:
            raise RequestError(f"body is not a readable .npz archive: {e}")
        if "images" not in data.files:
            raise RequestError('npz body must contain an "images" array')
        arr = data["images"]
    if arr.ndim == 3:
        arr = arr[None]
    if arr.ndim != 4 or arr.shape[-1] != 3:
        raise RequestError(f"images must be (H,W,3) or (N,H,W,3), got {arr.shape}")
    if arr.shape[0] == 0:
        raise RequestError("empty image batch")
    if arr.dtype != np.uint8:
        if np.issubdtype(arr.dtype, np.floating) and arr.max() <= 1.0 + 1e-6:
            arr = (np.clip(arr, 0, 1) * 255).round()
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    return arr


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


class VisCoINServer:
    """Engine + per-endpoint micro-batchers + HTTP plumbing."""

    def __init__(self, engine, max_delay_ms: float = 5.0, top_k: int = 5):
        self.engine = engine
        self.top_k = top_k
        self._amplify_lock = threading.Lock()
        self._batchers = {
            name: MicroBatcher(self._make_runner(name), engine.batch_size, max_delay_ms)
            for name in ("classify", "reconstruct", "explain")
        }

    def _make_runner(self, name: str):
        fn = getattr(self.engine, name)

        def run(items: list) -> list:
            out = fn(np.stack(items))
            return [{k: v[i] for k, v in out.items()} for i in range(len(items))]

        return run

    def close(self):
        for b in self._batchers.values():
            b.close()

    def _gather(self, name: str, images: np.ndarray) -> dict:
        """Submit each image on its own (coalesces across clients) and
        gather the rows back into batch-shaped outputs."""
        prep = np.stack([self.engine.prepare_image(im) for im in images])
        futures = [self._batchers[name].submit(im) for im in prep]
        rows = [f.result() for f in futures]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}

    def handle_classify(self, images: np.ndarray, params: dict) -> tuple[str, bytes]:
        out = self._gather("classify", images)
        k = min(int(params.get("top_k", self.top_k)), out["probas"].shape[-1])
        order = np.argsort(out["probas"], axis=-1)[:, ::-1][:, :k]
        order_e = np.argsort(out["expl_probas"], axis=-1)[:, ::-1][:, :k]
        kc = min(int(params.get("top_k", self.top_k)), out["concepts"].shape[-1])
        order_c = np.argsort(out["concepts"], axis=-1)[:, ::-1][:, :kc]
        resp = {
            "preds": np.argmax(out["logits"], -1).tolist(),
            "expl_preds": np.argmax(out["expl_logits"], -1).tolist(),
            "top_classes": order.tolist(),
            "top_probas": np.take_along_axis(out["probas"], order, -1).tolist(),
            "top_expl_classes": order_e.tolist(),
            "top_expl_probas": np.take_along_axis(out["expl_probas"], order_e, -1).tolist(),
            "top_concepts": order_c.tolist(),
            "top_concept_activations": np.take_along_axis(out["concepts"], order_c,
                                                          -1).tolist(),
        }
        return "application/json", json.dumps(resp).encode()

    def handle_reconstruct(self, images: np.ndarray, params: dict) -> tuple[str, bytes]:
        out = self._gather("reconstruct", images)
        return "application/octet-stream", _npz_bytes(
            reconstruction_u8=out["reconstruction_u8"], preds=out["preds"],
            expl_preds=out["expl_preds"])

    def handle_explain(self, images: np.ndarray, params: dict) -> tuple[str, bytes]:
        try:
            out = self._gather("explain", images)
        except KeyError as e:  # a sealed artifact exported without `explain`
            raise RequestError(str(e))
        k = min(int(params.get("top_k", self.top_k)), out["concepts"].shape[-1])
        order_c = np.argsort(out["concepts"], axis=-1)[:, ::-1][:, :k]
        heatmaps = {key: out[key] for key in out if key.startswith("heatmap_")}
        return "application/octet-stream", _npz_bytes(
            preds=out["preds"], expl_preds=out["expl_preds"], top_concepts=order_c,
            top_concept_activations=np.take_along_axis(out["concepts"], order_c, -1),
            **heatmaps)

    def handle_amplify(self, images: np.ndarray, params: dict) -> tuple[str, bytes]:
        if not hasattr(self.engine, "amplify"):
            raise RequestError("amplify is unavailable on this server (a sealed artifact "
                               "exports classify, reconstruct and explain only)")
        if images.shape[0] != 1:
            raise RequestError("amplify takes exactly one image per request")
        multipliers = [float(m) for m in str(params.get("multipliers", "0,1,2,4")).split(",")]
        if "top_k_concepts" in params:
            selection = {"method": "top_k", "k": int(params["top_k_concepts"])}
        elif "indices" in params:
            selection = {"method": "indices",
                         "indices": [int(i) for i in str(params["indices"]).split(",")]}
        else:
            selection = {"method": "threshold", "threshold": float(params.get("threshold", 0.2))}
        with self._amplify_lock:
            res = self.engine.amplify(images[0], selection, multipliers,
                                      seed=int(params.get("seed", 0)))
        res_px = self.engine.resolution
        amp = np.stack(res.amplified_images) if res.amplified_images else \
            np.zeros((0, res_px, res_px, 3), np.float32)
        amp01 = amp * np.asarray(IMAGENET_STD, np.float32) + np.asarray(IMAGENET_MEAN, np.float32)
        amp_u8 = (np.clip(amp01, 0, 1) * 255).round().astype(np.uint8)
        return "application/octet-stream", _npz_bytes(
            amplified_u8=amp_u8,
            probas_best=np.asarray(res.best_concept_probas_best, np.float32),
            probas_rand=np.asarray(res.best_concept_probas_rand, np.float32),
            default_probas=np.asarray(res.default_probas, np.float32),
            multipliers=np.asarray(res.multipliers, np.float32))

    def stats(self) -> dict:
        return {name: b.stats.snapshot() for name, b in self._batchers.items()}

    def make_server(self, host: str = "127.0.0.1", port: int = 8751) -> ThreadingHTTPServer:
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _send(self, code: int, content_type: str, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, obj):
                self._send(code, "application/json", json.dumps(obj).encode())

            def do_GET(self):
                if self.path == "/healthz":
                    self._send_json(200, {
                        "status": "ok",
                        "resolution": outer.engine.resolution,
                        "batch_size": outer.engine.batch_size,
                        "compute_dtype": outer.engine.compute_dtype,
                        "device": str(outer.engine.device),
                    })
                elif self.path == "/v1/stats":
                    self._send_json(200, outer.stats())
                else:
                    self._send_json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                url = urlparse(self.path)
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                route = {"/v1/classify": outer.handle_classify,
                         "/v1/reconstruct": outer.handle_reconstruct,
                         "/v1/amplify": outer.handle_amplify,
                         "/v1/explain": outer.handle_explain}.get(url.path)
                if route is None:
                    self._send_json(404, {"error": f"no route {url.path}"})
                    return
                try:
                    images = _decode_images(body, self.headers.get("Content-Type", ""))
                    content_type, payload = route(images, dict(parse_qsl(url.query)))
                    self._send(200, content_type, payload)
                except ValueError as e:
                    # RequestError, and malformed query params (int("abc")).
                    self._send_json(400, {"error": str(e)})
                except Exception as e:  # a server fault: report it, keep serving
                    self._send_json(500, {"error": f"{type(e).__name__}: {e}"})

        return ThreadingHTTPServer((host, port), Handler)


def run_server(engine, host: str = "127.0.0.1", port: int = 8751,
               max_delay_ms: float = 5.0):
    """Blocking serve loop (the ``serve`` command's). Prints the bound
    address, so that a caller of port 0 can read it, and, once stopped, that
    the micro-batchers are closed."""
    vs = VisCoINServer(engine, max_delay_ms=max_delay_ms)
    httpd = vs.make_server(host, port)
    print(f"viscoin_tpu_torch serving on http://{host}:{httpd.server_address[1]} "
          f"(batch {engine.batch_size}, {engine.resolution}px, {engine.compute_dtype}, "
          f"{engine.device})", flush=True)
    try:
        httpd.serve_forever()
    finally:
        vs.close()
        httpd.server_close()
        print("viscoin_tpu_torch server stopped; micro-batchers closed", flush=True)
