"""Embedding HTTP server: production serving for a trained MSML model.

Counterpart of `msml_tpu/cli/serve.py`. Serves a weight folder (the live
model of `core/weight_folder.py`) or a `tools/export_serving.py` artifact
(`torch.export`, the kernels inside as custom ops) behind a
dependency-free HTTP API, with two serving disciplines:

- **dynamic batching**: concurrent requests are gathered into one device
  batch (up to `--max-batch`, waiting at most `--batch-window-ms`), so
  single-image callers still fill the card;
- **static shape buckets**: batches are zero-padded to power-of-two
  bucket sizes, so the card sees a handful of batch sizes (cuDNN picks
  its algorithms and Triton compiles once per size, at `--warmup`).

API (all responses JSON unless noted):
  GET  /healthz      -> {"status": "ok", ...model metadata}
  GET  /metrics      -> Prometheus text: request/batch/image counters,
                     queue depth, request-latency histogram
  POST /embed        body = image bytes: binary PPM (read without PIL, the
                     only format on a machine without Pillow) or any
                     PIL-decodable format; the eval transform (resize,
                     center crop, [-1,1] / gray) is applied server-side
                     -> {"embedding": [...]}
  POST /embed_batch  body = .npy of preprocessed f32 (B, H, W, C)
                     -> {"embeddings": [[...], ...]}

Features are flip-summed and l2-normalized by default (the eval
protocols' convention); `--no-flip` / `--raw` opt out. Runs on `cuda`
unless `--device cpu` is given. `--quant` and `--spatial` are not ported
yet.

Usage:
  python -m msml_torch.cli.serve --weight_folder out/arc18_msml_1 --port 8000
  python -m msml_torch.cli.serve --artifact model.pt2 --port 8000
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time

import numpy as np
import torch

_MAX_BODY = 64 * 1024 * 1024


def _buckets(max_batch: int):
    bs, b = [], 1
    while b < max_batch:
        bs.append(b)
        b *= 2
    return bs + [max_batch]


class Metrics:
    """Serving counters, rendered in Prometheus text exposition format
    (GET /metrics) with no client-library dependency. Thread-safe; all
    observations are O(1) under one lock."""

    LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                       0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

    def __init__(self, queue_depth=lambda: 0):
        self._lock = threading.Lock()
        self._queue_depth = queue_depth
        self.requests_total = 0
        self.errors_total = 0
        self.batches_total = 0
        self.images_total = 0
        self.latency_sum = 0.0
        self.latency_count = 0
        self.latency_hist = [0] * len(self.LATENCY_BUCKETS)

    def observe_request(self, seconds: float, error: bool = False):
        with self._lock:
            self.requests_total += 1
            if error:
                self.errors_total += 1
            self.latency_sum += seconds
            self.latency_count += 1
            for i, edge in enumerate(self.LATENCY_BUCKETS):
                if seconds <= edge:
                    self.latency_hist[i] += 1

    def observe_batch(self, n: int):
        with self._lock:
            self.batches_total += 1
            self.images_total += int(n)

    def render(self) -> str:
        with self._lock:
            lines = [
                "# TYPE msml_requests_total counter",
                f"msml_requests_total {self.requests_total}",
                "# TYPE msml_request_errors_total counter",
                f"msml_request_errors_total {self.errors_total}",
                "# TYPE msml_device_batches_total counter",
                f"msml_device_batches_total {self.batches_total}",
                "# TYPE msml_images_total counter",
                f"msml_images_total {self.images_total}",
                "# TYPE msml_queue_depth gauge",
                f"msml_queue_depth {self._queue_depth()}",
                "# TYPE msml_request_latency_seconds histogram",
            ]
            # observe_request stores the histogram cumulatively, which is
            # exactly Prometheus's bucket semantics — emit as-is
            for edge, n in zip(self.LATENCY_BUCKETS, self.latency_hist):
                lines.append('msml_request_latency_seconds_bucket'
                             f'{{le="{edge}"}} {n}')
            lines.append('msml_request_latency_seconds_bucket{le="+Inf"} '
                         f"{self.latency_count}")
            lines.append("msml_request_latency_seconds_sum "
                         f"{self.latency_sum:.6f}")
            lines.append("msml_request_latency_seconds_count "
                         f"{self.latency_count}")
        return "\n".join(lines) + "\n"


class Batcher:
    """Gather concurrent single-image requests into padded device batches.

    One inference thread owns the device; handler threads block on a
    per-request Event. Inference errors propagate to every request in the
    failed batch. `close` ends the inference thread.
    """

    def __init__(self, infer, max_batch: int = 32, window_ms: float = 5.0,
                 request_timeout: float = 120.0, metrics: Metrics = None):
        self._infer = infer  # (B, H, W, C) f32 -> (B, D) np.ndarray
        self._max = int(max_batch)
        self._window = float(window_ms) / 1e3
        self._timeout = float(request_timeout)
        self._bucket_sizes = _buckets(self._max)
        self._q = queue.Queue()
        # every batcher carries metrics (cheap, lock-guarded counters);
        # GET /metrics renders them
        self.metrics = metrics or Metrics(queue_depth=self._q.qsize)
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def submit(self, x: np.ndarray, timeout: float | None = None) -> np.ndarray:
        ev, slot = threading.Event(), {}
        self._q.put((x, ev, slot))
        if not ev.wait(self._timeout if timeout is None else timeout):
            raise TimeoutError("inference timed out")
        if "err" in slot:
            raise slot["err"]
        return slot["y"]

    def close(self, timeout: float = 60.0):
        """End the inference thread once the requests queued before this
        call are answered."""
        self._q.put(None)
        self._t.join(timeout)

    def _loop(self):
        while True:
            first = self._q.get()
            if first is None:
                return
            batch = [first]
            deadline = time.monotonic() + self._window
            while len(batch) < self._max:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    item = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if item is None:  # close(): end after this batch
                    self._q.put(None)
                    break
                batch.append(item)
            xs = np.stack([b[0] for b in batch]).astype(np.float32)
            try:
                ys = self.run_padded(xs)
                for i, (_, ev, slot) in enumerate(batch):
                    slot["y"] = ys[i]
                    ev.set()
            except Exception as e:  # propagate to all waiters
                for _, ev, slot in batch:
                    slot["err"] = e
                    ev.set()

    def run_padded(self, xs: np.ndarray) -> np.ndarray:
        """Pad (B,...) to the next bucket size, run, slice back."""
        n = xs.shape[0]
        bucket = next((b for b in self._bucket_sizes if b >= n), None)
        if bucket is None:  # larger than max batch: chunk
            outs = [self.run_padded(xs[s:s + self._max])
                    for s in range(0, n, self._max)]
            return np.concatenate(outs, axis=0)
        if bucket != n:
            pad = np.zeros((bucket - n,) + xs.shape[1:], xs.dtype)
            xs = np.concatenate([xs, pad], axis=0)
        out = np.asarray(self._infer(xs))[:n]
        if self.metrics is not None:
            self.metrics.observe_batch(n)
        return out


class ModelRunner:
    """Preprocessing + (flip-sum, l2-norm) policy around a raw forward."""

    def __init__(self, raw_infer, out_size, is_gray, use_norm,
                 flip=True, l2_norm=True, meta=None):
        self.out_size = tuple(out_size)
        self.is_gray = bool(is_gray)
        self.use_norm = bool(use_norm)
        self.flip = bool(flip)
        self.l2_norm = bool(l2_norm)
        self.meta = dict(meta or {})
        self._raw = raw_infer

    def infer(self, x: np.ndarray) -> np.ndarray:
        """(B, H, W, C) preprocessed f32 -> (B, D) policy-applied feats."""
        f = np.asarray(self._raw(x), np.float32)
        if self.flip:
            f = f + np.asarray(self._raw(x[:, :, ::-1, :]), np.float32)
        if self.l2_norm:
            from msml_torch.eval.verification import l2_normalize_np
            f = l2_normalize_np(f)
        return f

    def preprocess_image(self, data: bytes) -> np.ndarray:
        from msml_torch.eval.folder_eval import (decode_image,
                                                 tensorize_folder_img)
        return tensorize_folder_img(decode_image(data), self.out_size,
                                    self.use_norm, self.is_gray, flip=False)

    @property
    def input_shape(self):
        return (self.out_size[1], self.out_size[0],
                1 if self.is_gray else 3)


def numpy_forward(module, device: torch.device):
    """(B, H, W, C) float32 numpy -> (B, D) float32 numpy through `module`
    (NHWC in, as `tools.export_serving.EvalForward` and the programs it
    exports take it) on `device`.

    Grad mode is per thread, so each call sets inference mode itself: the
    batcher's thread and an `/embed_batch` handler's thread run it side by
    side. It never switches the module's train/eval mode, which would race
    between the two."""

    @torch.inference_mode()
    def raw(x: np.ndarray) -> np.ndarray:
        img = torch.as_tensor(np.ascontiguousarray(x, np.float32),
                              device=device)
        return module(img).float().cpu().numpy()

    return raw


def runner_from_weight_folder(weight_folder: str, device="cuda",
                              **policy) -> ModelRunner:
    from msml_torch import resolve_device
    from msml_torch.core.weight_folder import load_weight_folder
    from msml_torch.tools.export_serving import EvalForward

    dev = resolve_device(device)
    cfg, model = load_weight_folder(weight_folder, device=dev)  # eval mode
    return ModelRunner(
        numpy_forward(EvalForward(model), dev), cfg.out_size,
        cfg.get("is_gray", False), cfg.get("use_norm", True),
        meta={"source": weight_folder, "network": cfg.frb_type,
              "dim": int(cfg.dim_feature)}, **policy)


def runner_from_artifact(path: str, device="cuda", **policy) -> ModelRunner:
    """Serve a `tools/export_serving.py` artifact on the device it was
    exported on; the model code (`msml_torch.nn`) is not imported — only
    the kernels, whose custom ops the program calls, and the exporter's
    sidecar metadata."""
    import msml_torch.kernels  # noqa: F401  (registers the custom ops)
    from msml_torch import resolve_device

    dev = resolve_device(device)
    program = torch.export.load(path)
    exported_on = {t.device.type for t in program.state_dict.values()}
    if exported_on != {dev.type}:
        raise SystemExit(f"{path} holds weights on {sorted(exported_on)}, "
                         f"not {dev.type}: export it with --device "
                         f"{dev.type}")
    with open(path + ".json") as f:
        meta = json.load(f)
    h, w, c = meta["input_hwc"]
    return ModelRunner(
        numpy_forward(program.module(), dev), (w, h), c == 1,
        meta.get("use_norm", True),
        meta={"source": path, **{k: meta[k] for k in ("network", "dim")
                                 if k in meta}}, **policy)


def make_handler(runner: ModelRunner, batcher: Batcher):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _send(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def do_GET(self):
            if self.path in ("/healthz", "/"):
                self._send(200, {"status": "ok",
                                 "input_hwc": list(runner.input_shape),
                                 "flip_sum": runner.flip,
                                 "l2_norm": runner.l2_norm, **runner.meta})
            elif self.path == "/metrics" and batcher.metrics is not None:
                body = batcher.metrics.render().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": "unknown path"})

        def _body(self):
            n = int(self.headers.get("Content-Length", 0))
            if n <= 0 or n > _MAX_BODY:
                raise ValueError(f"bad Content-Length {n}")
            return self.rfile.read(n)

        def do_POST(self):
            t0 = time.monotonic()
            err = False
            try:
                if self.path == "/embed":
                    x = runner.preprocess_image(self._body())
                    y = batcher.submit(x)
                    self._send(200, {"embedding": y.tolist()})
                elif self.path == "/embed_batch":
                    arr = np.load(io.BytesIO(self._body()),
                                  allow_pickle=False)
                    want = runner.input_shape
                    if arr.ndim != 4 or tuple(arr.shape[1:]) != want:
                        raise ValueError(
                            f"expected (B,{','.join(map(str, want))}), "
                            f"got {arr.shape}")
                    y = batcher.run_padded(arr.astype(np.float32))
                    self._send(200, {"embeddings": y.tolist()})
                else:
                    err = True
                    self._send(404, {"error": "unknown path"})
            except Exception as e:  # noqa: BLE001 - surface as 400
                err = True
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
            finally:
                if batcher.metrics is not None:
                    batcher.metrics.observe_request(time.monotonic() - t0,
                                                    error=err)

    return Handler


def build_server(runner: ModelRunner, host="127.0.0.1", port=0,
                 max_batch=32, window_ms=5.0, request_timeout=120.0):
    from http.server import ThreadingHTTPServer

    class Server(ThreadingHTTPServer):
        # the listen backlog: socketserver's 5 resets the connections of
        # clients that arrive together, the traffic dynamic batching is for
        request_queue_size = 1024

    batcher = Batcher(lambda x: runner.infer(x), max_batch=max_batch,
                      window_ms=window_ms, request_timeout=request_timeout)
    httpd = Server((host, port), make_handler(runner, batcher))
    return httpd, batcher


def warmup(runner: ModelRunner, max_batch: int):
    """Run every bucket once, so that the first request of each size finds
    the kernels built and cuDNN's algorithms chosen."""
    for b in _buckets(max_batch):
        runner.infer(np.zeros((b,) + runner.input_shape, np.float32))


def main(args):
    not_ported = [name for name, on in (
        (f"--quant {args.quant}", bool(args.quant)),
        (f"--spatial {args.spatial}", args.spatial > 1)) if on]
    if not_ported:
        raise SystemExit("not ported yet: " + ", ".join(not_ported))

    policy = {"flip": args.flip, "l2_norm": args.l2_norm}
    if args.artifact:
        runner = runner_from_artifact(args.artifact, args.device, **policy)
    else:
        runner = runner_from_weight_folder(args.weight_folder, args.device,
                                           **policy)
    if args.warmup:
        warmup(runner, args.max_batch)

    httpd, batcher = build_server(runner, args.host, args.port,
                                  args.max_batch, args.batch_window_ms,
                                  args.request_timeout)
    print(f"serving on http://{args.host}:{httpd.server_address[1]} "
          f"(input {runner.input_shape}, max_batch {args.max_batch}, "
          f"{args.device})", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        batcher.close()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="msml_torch embedding server")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--weight_folder")
    src.add_argument("--artifact",
                     help="a torch.export program from tools/export_serving")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--batch-window-ms", type=float, default=5.0)
    p.add_argument("--request-timeout", type=float, default=120.0,
                   help="per-request wait bound; raise when serving "
                        "without --warmup (the kernels build at first use)")
    p.add_argument("--flip", action="store_true", default=True,
                   help="flip-sum features (the eval protocols' default)")
    p.add_argument("--no-flip", dest="flip", action="store_false")
    p.add_argument("--l2-norm", action="store_true", default=True)
    p.add_argument("--raw", dest="l2_norm", action="store_false")
    p.add_argument("--no-warmup", dest="warmup", action="store_false",
                   default=True)
    p.add_argument("--quant", default="", choices=["", "int8"],
                   help="not ported yet")
    p.add_argument("--spatial", type=int, default=1, help="not ported yet")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def cli():
    """Console entry point."""
    main(parse_args())


if __name__ == "__main__":
    cli()
