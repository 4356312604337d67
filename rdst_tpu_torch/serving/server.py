"""Dependency-free HTTP inference server with cross-request batching
(counterpart of ``rdst_tpu/serving/server.py``).

Stdlib only (``http.server`` + threads).

Endpoints
---------

* ``GET /healthz`` -- liveness: ``{"status": "ok"}``.
* ``GET /v1/metadata`` -- the model manifest (identity, scales, dtype,
  kernel mode, device).
* ``POST /v1/predict?scale=4`` -- body is an ``.npy`` payload
  (``np.save`` bytes) of shape (H,W) / (N,H,W) / (N,H,W,C); the response
  is the f32 HR ``.npy``. Errors come back as JSON with status 400.

Concurrent requests for the same (scale, LR shape) are coalesced by one
dispatcher thread within a ``batch_wait_ms`` window and run as one
padded batch, so concurrency turns into batch occupancy on the card.
One thread owns the device; HTTP threads only wait on their slot. Every
thread the server starts is a daemon.
"""

from __future__ import annotations

import io
import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np


class _Slot:
    """One request's place in the batch queue."""

    __slots__ = ("x", "scale", "event", "out", "err")

    def __init__(self, x: np.ndarray, scale: float):
        self.x, self.scale = x, scale
        self.event = threading.Event()
        self.out: Optional[np.ndarray] = None
        self.err: Optional[Exception] = None


class Batcher:
    """Coalesce same-(scale, LR shape) requests into one dispatch."""

    def __init__(self, predictor, max_batch: int = 64,
                 batch_wait_ms: float = 5.0):
        self.predictor = predictor
        self.max_batch = int(max_batch)
        self.wait_s = float(batch_wait_ms) / 1e3
        self.q: "queue.Queue[_Slot]" = queue.Queue()
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="rdst-batcher")
        self.thread.start()

    def submit(self, x: np.ndarray, scale: float) -> np.ndarray:
        if self._stop.is_set():
            raise RuntimeError("batcher is shut down")
        slot = _Slot(x, float(scale))
        self.q.put(slot)
        # poll the stop flag so a shutdown racing this submit can never
        # leave the caller blocked on an abandoned slot
        while not slot.event.wait(0.5):
            if self._stop.is_set() and not slot.event.is_set():
                raise RuntimeError("batcher shut down mid-request")
        if slot.err is not None:
            raise slot.err
        return slot.out

    def close(self):
        self._stop.set()
        self.q.put(None)  # wake the dispatcher
        self.thread.join(timeout=5)
        # fail anything still queued so no submitter blocks forever
        while True:
            try:
                got = self.q.get_nowait()
            except queue.Empty:
                break
            if got is not None:
                got.err = RuntimeError("batcher is shut down")
                got.event.set()

    # -- dispatcher ---------------------------------------------------------

    def _key(self, s: _Slot):
        return (s.scale, s.x.shape[1:])

    def _run(self):
        import time

        pending: list = []
        while not self._stop.is_set():
            if not pending:
                got = self.q.get()
                if got is None:
                    continue
                pending.append(got)
            # gather more compatible work within the batching window
            deadline = time.monotonic() + self.wait_s
            key = self._key(pending[0])
            n = pending[0].x.shape[0]
            while n < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    got = self.q.get(timeout=timeout)
                except queue.Empty:
                    break
                if got is None:
                    continue
                if self._key(got) == key and n + got.x.shape[0] <= self.max_batch:
                    pending.append(got)
                    n += got.x.shape[0]
                else:
                    # different shape/scale: dispatch current group first
                    self._dispatch(pending)
                    pending = [got]
                    deadline = time.monotonic() + self.wait_s
                    key = self._key(got)
                    n = got.x.shape[0]
            if pending:
                self._dispatch(pending)
                pending = []

    def _dispatch(self, group):
        try:
            x = np.concatenate([s.x for s in group], axis=0)
            out = self.predictor.predict(x, group[0].scale)
            i = 0
            for s in group:
                s.out = out[i:i + s.x.shape[0]]
                i += s.x.shape[0]
        except Exception as e:  # deliver the failure to every waiter
            for s in group:
                s.err = e
        finally:
            for s in group:
                s.event.set()


def make_handler(batcher: Batcher, manifest: dict):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(200, {"status": "ok"})
            elif path == "/v1/metadata":
                self._json(200, manifest)
            else:
                self._json(404, {"error": f"unknown path {path}"})

        def do_POST(self):
            u = urlparse(self.path)
            if u.path != "/v1/predict":
                self._json(404, {"error": f"unknown path {u.path}"})
                return
            try:
                qs = parse_qs(u.query)
                scale = float(qs.get("scale", ["4"])[0])
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                from rdst_tpu_torch.serving.export import _canon_input

                x = _canon_input(np.load(io.BytesIO(raw),
                                         allow_pickle=False))
                out = batcher.submit(x, scale)
                buf = io.BytesIO()
                np.save(buf, out)
                self._send(200, buf.getvalue(), "application/octet-stream")
            except Exception as e:
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class _BurstHTTPServer(ThreadingHTTPServer):
    # socketserver's default listen backlog is 5: a burst of concurrent
    # clients (the point of the micro-batching server) would overflow the
    # accept queue and the OS would reset connections
    request_queue_size = 128


class InferenceServer:
    """Own a predictor + batcher + HTTP server; ``port=0`` auto-picks."""

    def __init__(self, predictor, host: str = "127.0.0.1", port: int = 8000,
                 max_batch: int = 64, batch_wait_ms: float = 5.0):
        manifest = getattr(predictor, "manifest", {})
        self.batcher = Batcher(predictor, max_batch, batch_wait_ms)
        self.httpd = _BurstHTTPServer(
            (host, port), make_handler(self.batcher, manifest))
        self.port = self.httpd.server_address[1]
        self._serving = False

    def warmup(self, lr_hw=None, scale=None, channels: int = 1) -> float:
        """Run every batch bucket of the predictor's ladder once, so the
        first burst meets steady-state latency (cuDNN algorithm choice,
        kernel build and load happen here). Warm points: the explicit
        ``(lr_hw, scale)``, else every manifest entry. Returns seconds."""
        import time

        from rdst_tpu_torch.serving.export import resolve_buckets

        if lr_hw is not None:
            if scale is None:
                raise ValueError("warmup(lr_hw=...) needs scale=")
            pts = [(tuple(int(v) for v in lr_hw), float(scale))]
        else:
            manifest = getattr(self.batcher.predictor, "manifest", {})
            pts = [(tuple(e["lr_hw"]), float(e["scale"]))
                   for e in manifest.get("entries", [])]
        buckets = getattr(self.batcher.predictor, "buckets", None)
        if not buckets:
            buckets = resolve_buckets(self.batcher.max_batch)
        t0 = time.time()
        for hw, sc in pts:
            shape = hw if channels == 1 else hw + (int(channels),)
            for b in buckets:
                self.batcher.predictor.predict(
                    np.zeros((b,) + shape, np.float32), sc)
        return round(time.time() - t0, 2)

    def serve_forever(self):
        self._serving = True
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        self._serving = True
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                             name="rdst-httpd")
        t.start()
        return t

    def close(self):
        """Stop serving and the dispatcher. Safe before serving began
        (``shutdown`` would otherwise wait for a loop that never ran)."""
        if self._serving:
            self.httpd.shutdown()
            self._serving = False
        self.httpd.server_close()
        self.batcher.close()


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="rdst_tpu_torch inference server")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--bundle", help="exported serving bundle directory "
                     "(not ported yet: raises)")
    src.add_argument("--config-file", help="serve a live model from a "
                     "training config")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--buckets", default=None,
                    help="batch-bucket ladder: comma list ('1,8,64', the "
                    "default) or 'pow2' for the dense ladder")
    ap.add_argument("--batch-wait-ms", type=float, default=5.0)
    ap.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                    help="device to serve on (default: cuda)")
    ap.add_argument("--warmup-shape", type=int, nargs=2, metavar=("H", "W"),
                    default=None,
                    help="LR shape to warm every batch bucket at, for "
                    "every configured scale, before accepting traffic")
    ap.add_argument("set", nargs="*",
                    help="KEY=VALUE config overrides, values parsed like "
                    ".ini values, e.g. well_trained_single_scale_model_g="
                    "\"'weights/rdst_e1_40k_best_oasis20_x4.msgpack'\"")
    args = ap.parse_args(argv)

    if args.bundle:
        raise NotImplementedError(
            "--bundle: exported serving bundles are not ported; serve a "
            "config with --config-file")
    from rdst_tpu_torch.config import ParametersLoader
    from rdst_tpu_torch.serving.export import LiveModel

    paras = ParametersLoader(args.config_file)
    paras.apply_overrides(args.set)
    predictor = LiveModel(paras, max_batch=args.max_batch,
                          buckets=args.buckets,
                          device=args.platform or "cuda")
    srv = InferenceServer(predictor, args.host, args.port,
                          args.max_batch, args.batch_wait_ms)
    if args.warmup_shape is not None:
        for sc in predictor.manifest.get("scales", []):
            dt = srv.warmup(lr_hw=args.warmup_shape, scale=sc)
            print(f"warmed {tuple(args.warmup_shape)} x{sc} in {dt}s")
    print(f"serving {predictor.manifest.get('model_name', '?')} on "
          f"{predictor.manifest['device']} at http://{args.host}:{srv.port}",
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()


if __name__ == "__main__":
    main()
