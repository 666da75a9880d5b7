"""Online HTTP serving: frames in, homography JSON out (port of
``serve/server.py``).  Run it with::

    python -m sports_field_homography_tpu_torch.serve.server \\
        --load ckpt/CP_epoch30.msgpack --port 8800
    curl -s --data-binary @frame.png localhost:8800/predict

The predict CLI's device program (``cli/engine.predict_fn``: uint8 frames
divided by 255 on the device, BN folded, K1 on the logits grid for the
score or on the full grid for ``warp_mask``) behind a dynamic batcher
(``serve/batcher.py``) and the standard library's ``ThreadingHTTPServer``.
The weights are a reference-keyed ``.pth`` or the JAX package's
``.msgpack``, with the ``conf.yaml`` beside them, as for the predict CLI.

Or an exported program (``--serving_artifact``, written by
``cli.export_serving``; ``compat/serving.py``), which holds its weights and
court constants and loads without the model code, on the device it was
exported on (``--device``)::

    python -m sports_field_homography_tpu_torch.cli.export_serving \
        --load ckpt/CP_epoch30.pth --buckets 1,2,4,8,16,32 --dst ckpt/serving
    python -m sports_field_homography_tpu_torch.serve.server \
        --serving_artifact ckpt/serving --port 8800

A directory of ``b{N}`` artifacts serves exactly those buckets, one
fixed-batch artifact pins the batcher to its batch, and a ``poly_batch``
artifact takes ``--buckets`` (default: powers of two up to ``--max_batch``).

Endpoints (the JAX server's):
  * ``POST /predict`` -- body = one encoded image.  With cv2 installed, any
    format and size cv2 reads, resized to the model's size as the video
    source does; without cv2, PNGs already at the model's size only.
    Response JSON: ``{"theta": 3x3, "score": float, "poi": [[x, y]...]}``
    per ``--req_outputs``; masks are base64 PNGs.
  * ``GET /healthz`` -- liveness and the torch device type.
  * ``GET /stats``   -- batcher counters and latency quantiles (JSON).
  * ``GET /metrics`` -- the same counters in the Prometheus text format.

SIGTERM drains: the server stops accepting, serves what is queued, and
exits 0.  Refused before any model is built: ``--num_devices`` above 1 with
a checkpoint (ROADMAP.md queue 1 item 9); with an artifact it is logged
and ignored, as the JAX server does.
"""
from __future__ import annotations

import base64
import glob
import json
import os
import re
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict

import numpy as np
import torch

from ..cli.engine import build_model, discover_conf, predict_fn
from ..compat.serving import load_serving, read_meta
from ..data.image import have_cv2
from ..data.png import decode_png, encode_png
from ..utils.config import get_serving_args, parse_config, replace_args
from ..utils.logger import get_logger
from .batcher import DynamicBatcher, default_buckets

__all__ = ["create_server", "main"]

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# the JAX server's conf overlay list, plus the port's device (a run-time choice)
_CONF_IGNORE = ["conf_path", "batchsize", "load", "compute_dtype", "num_devices",
                "req_outputs", "device"]


def _check_slice(args) -> None:
    """Raise, before any model is built, on what this port does not serve
    (``--num_devices`` with an artifact is ignored in ``create_server``)."""
    devices = None if args.serving_artifact else args.num_devices
    if devices not in (None, 1) or args.num_hosts is not None \
            or args.coordinator is not None:
        raise NotImplementedError(
            "--num_devices: multi-device serving is ROADMAP.md queue 1 item 9 (step 7)")


def _decode_frame(raw: bytes, target_hw, channel_order: str) -> np.ndarray:
    """Request body -> (H, W, 3) uint8 frame at the model's size, in
    ``channel_order``; ``ValueError`` for a body that cannot be served.

    With cv2: ``imdecode(IMREAD_COLOR)`` (BGR), the ``rgb`` swap, then the
    video source's resize (INTER_AREA when shrinking, else INTER_LINEAR).
    Without: a PNG through ``data/png.decode_png``, converted as
    ``IMREAD_COLOR`` converts it (gray to three channels, alpha dropped,
    BGR order), which must already be at the model's size.
    """
    h, w = target_hw
    if have_cv2():
        import cv2

        frame = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
        if frame is None:
            raise ValueError("body is not a decodable image")
        if channel_order == "rgb":
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        if frame.shape[:2] != (h, w):
            inter = cv2.INTER_AREA if frame.shape[1] > w else cv2.INTER_LINEAR
            frame = cv2.resize(frame, (w, h), interpolation=inter)
        return frame
    if not raw.startswith(_PNG_SIGNATURE):
        raise ValueError("without cv2 (not installed) only PNG bodies are decoded")
    img = decode_png(raw, "request body")
    if img.ndim == 2:
        img = img[..., None]
    img = img[..., :1] if img.shape[2] == 2 else img[..., :3]     # drop alpha
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    if img.shape[:2] != (h, w):
        raise ValueError(f"the frame is {img.shape[1]}x{img.shape[0]}; resizing it to "
                         f"{w}x{h} needs cv2, which is not installed")
    return np.ascontiguousarray(img[..., ::-1] if channel_order == "bgr" else img)


def _response_json(result: Dict[str, np.ndarray]) -> dict:
    """Per-request predict slice -> JSON-ready dict (the JAX server's value
    conventions; masks as base64 gray PNGs)."""
    out = {}
    if "theta" in result:
        out["theta"] = np.asarray(result["theta"], np.float64).reshape(3, 3).tolist()
    if "consist_score" in result:
        out["score"] = float(result["consist_score"])
    if "poi" in result:
        out["poi"] = np.asarray(result["poi"], np.float64).tolist()
    for key in ("segm_mask", "warp_mask"):
        if key in result:
            png = encode_png(np.asarray(result[key], np.uint8))
            out[key + "_png"] = base64.b64encode(png).decode("ascii")
    return out


def _build_from_checkpoint(args):
    """The predict CLI's model construction, minus the dataset: the sidecar
    conf overlay (geometry and assets from the conf) and ``--req_outputs``
    -> the kept outputs.  Returns ``(run_batch, frame_shape, device)``."""
    args.conf_path = discover_conf(args.load, args.conf_path)
    if args.conf_path is not None:
        args = replace_args(args, parse_config(args.conf_path), ignore_keys=_CONF_IGNORE)

    req_outputs = [n for n in args.req_outputs.split(",") if n]
    consistency = "consistency" in req_outputs
    args.use_warper = "warp_mask" in req_outputs or consistency
    if consistency and not args.use_unet:
        raise ValueError("consistency needs the UNet")
    if "poi" in req_outputs and not args.use_warper:
        raise ValueError("poi needs the warper: ask for warp_mask or consistency too")
    keep = [k for k in ("segm_mask", "warp_mask", "theta", "poi") if k in req_outputs]
    if consistency:
        keep.append("consist_score")

    bundle = build_model(args, load=args.load, warp_with_nearest=True,
                         fold_bn=bool(args.fold_bn))
    w, h = bundle.config.target_size
    return predict_fn(bundle, consistency, keep), (h, w, 3), bundle.device


def _as_input(frames, dtype: str):
    """The batcher's uint8 frames in an artifact's input dtype: uint8 as
    they are, float32 in [0, 1] (what the program takes unnormalized)."""
    return frames if dtype == "uint8" else frames.float() / 255.0


def _build_from_artifact(path: str, device: str):
    """Serve exported programs (``compat/serving.py``), weights inside, no
    model code.  A directory of ``b{N}`` sub-artifacts (``cli.export_serving
    --buckets``) serves exactly those batches as its buckets; one
    fixed-batch artifact pins the batcher to its batch; a ``poly_batch``
    artifact takes the server's buckets.  Every artifact must have been
    exported for ``device``'s type.  Returns ``(run_batch, frame_shape,
    device, forced buckets or None)``."""
    subs = [d for d in glob.glob(os.path.join(path, "b*"))
            if re.fullmatch(r"b\d+", os.path.basename(d))
            and os.path.exists(os.path.join(d, "meta.json"))]
    dirs = subs or [path]
    specs = [read_meta(d)["input"] for d in dirs]
    frames = {tuple(int(v) for v in s["shape"][1:3]) for s in specs}
    dtypes = {s["dtype"] for s in specs}
    if len(frames) != 1 or len(dtypes) != 1:
        raise ValueError(f"bucket artifacts under {path} disagree on the frame size or "
                         f"input dtype: {sorted(frames)}, {sorted(dtypes)}")
    if subs and any(s["poly_batch"] for s in specs):
        raise ValueError(f"{path}: a poly_batch artifact in a b{{N}} bucket directory")
    (h, w), = frames
    (dtype,) = dtypes
    if not subs and specs[0]["poly_batch"]:
        poly, _ = load_serving(path, device)
        return (lambda x: poly(_as_input(x, dtype))), (h, w, 3), torch.device(device), None
    fns = {spec["shape"][0]: load_serving(d, device)[0] for d, spec in zip(dirs, specs)}

    def run_batch(x):
        fn = fns.get(x.shape[0])
        if fn is None:
            raise ValueError(f"no bucket artifact for batch {x.shape[0]} (have {sorted(fns)})")
        return fn(_as_input(x, dtype))

    return run_batch, (h, w, 3), torch.device(device), sorted(fns)


def _prometheus_metrics(stats: dict) -> str:
    """Batcher counters in the Prometheus text exposition format (the JAX
    server's names; ``/stats`` keeps the JSON view)."""
    lines = [
        "# TYPE sfh_requests_total counter",
        f"sfh_requests_total {stats['requests']}",
        "# TYPE sfh_batches_total counter",
        f"sfh_batches_total {stats['batches']}",
        "# TYPE sfh_errors_total counter",
        f"sfh_errors_total {stats['errors']}",
    ]
    if stats.get("mean_occupancy") is not None:
        lines += ["# TYPE sfh_batch_occupancy_mean gauge",
                  f"sfh_batch_occupancy_mean {stats['mean_occupancy']:.4f}"]
    lines.append("# TYPE sfh_batches_by_bucket_total counter")
    for bucket, n in stats["batch_hist"].items():
        lines.append(f'sfh_batches_by_bucket_total{{bucket="{bucket}"}} {n}')
    lat = stats.get("latency_ms") or {}
    lines.append("# TYPE sfh_request_latency_ms gauge")
    for q, v in lat.items():
        if v is not None:
            lines.append(f'sfh_request_latency_ms{{quantile="{q}"}} {v}')
    return "\n".join(lines) + "\n"


class _InFlight:
    """Counts POSTs between their read and their response, so that a
    draining server can wait for the last response to be written."""

    def __init__(self):
        self.n = 0
        self.cond = threading.Condition()

    def __enter__(self):
        with self.cond:
            self.n += 1

    def __exit__(self, *exc):
        with self.cond:
            self.n -= 1
            self.cond.notify_all()

    def wait_idle(self, timeout: float) -> bool:
        with self.cond:
            return self.cond.wait_for(lambda: self.n == 0, timeout)


class _Handler(BaseHTTPRequestHandler):
    # class-level service state, set by create_server
    batcher: DynamicBatcher = None
    target_hw: tuple = None
    channel_order: str = "bgr"
    backend: str = None
    inflight: _InFlight = None
    logger = None

    # the stdlib logs every request to stderr; route through our logger
    def log_message(self, fmt, *fmt_args):
        if self.logger is not None:
            self.logger.debug("%s - %s" % (self.address_string(), fmt % fmt_args))

    def _send(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._send(200, {"ok": True, "backend": self.backend})
        elif self.path == "/stats":
            self._send(200, self.batcher.stats())
        elif self.path == "/metrics":
            body = _prometheus_metrics(self.batcher.stats()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._send(404, {"error": "unknown path; use POST /predict, GET /healthz, "
                                      "GET /stats, GET /metrics"})

    def do_POST(self):
        if self.path != "/predict":
            self._send(404, {"error": "unknown path"})
            return
        with self.inflight:
            try:
                raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                h, w, _ = self.target_hw
                frame = _decode_frame(raw, (h, w), self.channel_order)
            except Exception as e:      # the client's fault: answer, keep serving
                self._send(400, {"error": f"bad request: {e}"})
                return
            try:
                result = self.batcher.submit(frame, timeout=120.0)
                self._send(200, _response_json(result))
            except TimeoutError:
                self._send(504, {"error": "predict timed out"})
            except Exception as e:      # the batch failed: answer, keep serving
                self._send(500, {"error": f"predict failed: {e}"})


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # the standard library listens with a backlog of 5, which resets
    # connections when dozens of clients connect at once
    request_queue_size = 128


def create_server(argv=None):
    """Build the service and a bound (not yet serving) HTTP server.

    Returns ``(httpd, batcher)``; call ``httpd.serve_forever()`` (main
    does) or drive it from a thread (tests do).  ``httpd.server_address``
    carries the bound port when ``--port 0``.
    """
    args = get_serving_args(argv)
    _check_slice(args)
    logger = get_logger(format="%(message)s", write_date=False)
    # also imports cv2 now rather than in the first request's handler
    logger.info("decoding request bodies with " + (
        "cv2" if have_cv2() else "data/png.py: PNG only, at the model's size (no cv2)"))
    forced = None
    if args.serving_artifact:
        if (args.num_devices or 1) > 1:
            logger.info("--num_devices is ignored with --serving_artifact (an artifact is "
                        "a one-device program; serve a checkpoint for more devices)")
        run_batch, frame_shape, device, forced = _build_from_artifact(
            args.serving_artifact, args.device)
    else:
        run_batch, frame_shape, device = _build_from_checkpoint(args)
    if forced is not None:
        buckets = forced
        logger.info(f"fixed-batch artifact: serving bucket {forced[0]} only (export with "
                    "--buckets or --poly_batch for size-adaptive buckets)"
                    if len(forced) == 1 else f"bucket artifacts: serving buckets {forced}")
    elif args.buckets:
        buckets = sorted(int(b) for b in args.buckets.split(","))
    else:
        buckets = default_buckets(args.max_batch)
    batcher = DynamicBatcher(run_batch, frame_shape, max_batch=buckets[-1],
                             max_delay_ms=args.max_delay_ms, buckets=buckets,
                             device=device)

    class Handler(_Handler):
        pass

    Handler.batcher = batcher
    Handler.target_hw = frame_shape
    Handler.channel_order = args.channel_order
    Handler.backend = device.type
    Handler.inflight = _InFlight()
    Handler.logger = logger
    try:
        if not args.no_warmup:
            logger.info(f"warming up batch buckets {list(buckets)}...")
            batcher.warmup()
        httpd = _Server((args.http_host, args.port), Handler)
    except BaseException:
        batcher.close()
        raise
    logger.info(f"serving on http://{httpd.server_address[0]}:{httpd.server_address[1]}  "
                f"(POST /predict, GET /healthz, GET /stats, GET /metrics)")
    return httpd, batcher


def main(argv=None):
    httpd, batcher = create_server(argv)

    # graceful drain on SIGTERM: stop accepting connections, let the batcher
    # serve everything already queued, then exit.  shutdown() blocks until
    # serve_forever returns, so it must be triggered off-thread.
    def _term(signum, frame):
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:
        pass  # not the main thread (embedded use); SIGTERM stays default

    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        # close() enqueues the shutdown sentinel behind pending requests:
        # the worker serves them and wakes their handler threads before it
        # joins; then wait for those threads to write their responses
        batcher.close()
        httpd.RequestHandlerClass.inflight.wait_idle(timeout=30.0)


if __name__ == "__main__":
    main()
