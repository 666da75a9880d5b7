"""Dynamic request batching for the online serving endpoint (port of
``serve/batcher.py``).

Protocol: each request thread calls :meth:`DynamicBatcher.submit`, which
enqueues the frame and blocks.  One worker thread drains the queue --
taking whatever is waiting, up to ``max_batch``, waiting at most
``max_delay_ms`` after the first frame arrives -- pads the group to the
smallest batch bucket by repeating frame 0, runs the program once, and
hands each request its slice.  Under load, batches fill to ``max_batch``
and the delay never triggers; at low rates a request pays at most
``max_delay_ms`` of coalescing latency.

The worker thread is the only one that touches the device: it stacks the
uint8 frames into a pinned host buffer (one per bucket), copies them to the
model's device, runs the program, and copies the outputs back to numpy once
per batch.  Request threads do host work only.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["DynamicBatcher", "default_buckets"]


def default_buckets(max_batch: int) -> tuple:
    """Powers of two up to ``max_batch`` (plus ``max_batch`` itself).

    Small buckets keep low-rate latency near the batch-1 floor; the top
    bucket carries the throughput.
    """
    buckets = []
    b = 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return tuple(buckets)


class _Pending:
    __slots__ = ("frame", "event", "result", "error", "t_submit")

    def __init__(self, frame: np.ndarray):
        self.frame = frame
        self.event = threading.Event()
        self.result: Optional[Dict[str, np.ndarray]] = None
        self.error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()


class _Warmup:
    """A request for the worker to run every bucket once."""

    def __init__(self):
        self.event = threading.Event()
        self.error: Optional[BaseException] = None


class DynamicBatcher:
    """Coalesce concurrent ``submit`` calls into batched ``run_batch`` calls.

    ``run_batch(frames)``: a ``(B, H, W, C)`` uint8 tensor on ``device`` -> dict
    of tensors with a leading batch dim (``cli/engine.predict_fn``; B is
    always one of ``buckets``).  ``frame_shape``: the per-frame
    ``(H, W, C)`` shape every submit must match.  ``warmup()`` runs every
    bucket once before the first request.
    """

    def __init__(self, run_batch: Callable, frame_shape,
                 max_batch: int = 32, max_delay_ms: float = 8.0,
                 buckets: Optional[Sequence[int]] = None, device="cuda"):
        self.run_batch = run_batch
        self.frame_shape = tuple(frame_shape)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # "cuda" is the current device of the caller, where the model is
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.max_delay = max_delay_ms / 1000.0
        self.buckets = tuple(sorted(buckets)) if buckets \
            else default_buckets(max_batch)
        if not all(b > 0 for b in self.buckets):
            raise ValueError(f"batch buckets must be positive: {self.buckets}")
        self.max_batch = self.buckets[-1]
        self._staging: Dict[int, torch.Tensor] = {}     # bucket -> pinned host batch
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._closed = False
        # stats (under _lock): request/batch counters, per-bucket batch
        # counts, occupancy sum, rolling latency window
        self.n_requests = 0
        self.n_batches = 0
        self.n_errors = 0
        self.batch_hist: collections.Counter = collections.Counter()
        self.occupancy_sum = 0
        self._latencies: collections.deque = collections.deque(maxlen=1024)
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="sfh-batcher")
        self._worker.start()

    # ------------------------------------------------------------- client
    def submit(self, frame: np.ndarray,
               timeout: Optional[float] = None) -> Dict[str, np.ndarray]:
        """Block until the frame's slice of a batched predict returns.

        Raises whatever the worker raised for the batch, or
        ``TimeoutError`` after ``timeout`` seconds.
        """
        frame = np.asarray(frame, dtype=np.uint8)
        if frame.shape != self.frame_shape:
            raise ValueError(f"frame shape {frame.shape} != expected "
                             f"{self.frame_shape}")
        if self._closed:
            raise RuntimeError("batcher is closed")
        item = _Pending(frame)
        self._q.put(item)
        self._wait(item, timeout)
        return item.result

    def _wait(self, item, timeout: Optional[float]) -> None:
        """Wait for the worker to finish ``item``; raise its error, or
        ``TimeoutError`` (the item is orphaned: the worker still fills it,
        nobody reads it), or ``RuntimeError`` if the worker thread died."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        while not item.event.wait(0.5):
            if not self._worker.is_alive():
                raise RuntimeError("the batcher's worker thread died")
            if deadline is not None and time.perf_counter() >= deadline:
                raise TimeoutError("predict timed out")
        if item.error is not None:
            raise item.error

    def warmup(self):
        """Run every bucket once on zero frames in the worker, synchronised:
        the kernels are built and cuDNN has its plans before the first
        request."""
        item = _Warmup()
        self._q.put(item)
        self._wait(item, None)

    def close(self):
        self._closed = True
        self._q.put(None)
        self._worker.join(timeout=30)
        # a submit that passed the _closed check but enqueued only after
        # the worker's own shutdown drain returned would block its caller
        # forever: nobody consumes the queue anymore, so fail it here
        self._fail_queued()

    def _fail_queued(self):
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                return
            if p is not None:
                p.error = RuntimeError("batcher is closed")
                p.event.set()

    # ------------------------------------------------------------- worker
    def _collect(self):
        """One group: first item blocking, then whatever arrives within
        ``max_delay`` of it, capped at ``max_batch``.  None = shutdown; a
        ``_Warmup`` comes alone."""
        item = self._q.get()
        if item is None or isinstance(item, _Warmup):
            return item
        group = [item]
        deadline = time.perf_counter() + self.max_delay
        while len(group) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None or isinstance(nxt, _Warmup):     # serve this group first
                self._q.put(nxt)
                break
            group.append(nxt)
        return group

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _host_batch(self, bucket: int) -> torch.Tensor:
        """The host batch the worker fills: on CUDA one pinned buffer per
        bucket, reused (the previous batch's H2D from it has finished: the
        D2H behind it on the stream was waited on); on the CPU a new one."""
        shape = (bucket,) + self.frame_shape
        if self.device.type != "cuda":
            return torch.empty(shape, dtype=torch.uint8)
        if bucket not in self._staging:
            self._staging[bucket] = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
        return self._staging[bucket]

    def _run(self, host: torch.Tensor) -> Dict[str, np.ndarray]:
        """One batch: H2D from the host batch, the program, D2H once."""
        if self.device.type != "cuda":
            with torch.inference_mode():
                out = self.run_batch(host)
            return {k: v.numpy() for k, v in out.items()}
        stream = torch.cuda.current_stream(self.device)
        with torch.inference_mode():
            out = self.run_batch(host.to(self.device, non_blocking=True))
            back = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    for k, v in out.items()}
            for k, v in out.items():
                back[k].copy_(v, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
        done.synchronize()
        return {k: v.numpy() for k, v in back.items()}

    def _loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)      # this thread's current device
        while True:
            group = self._collect()
            if group is None:
                # shutdown: anything that raced past the _closed check and
                # enqueued behind the sentinel would block its submitter
                # until timeout; fail those requests explicitly instead
                self._fail_queued()
                return
            if isinstance(group, _Warmup):
                try:
                    for b in self.buckets:
                        self._run(self._host_batch(b).zero_())
                except Exception as e:      # delivered to warmup()'s caller
                    group.error = e
                group.event.set()
                continue
            n = len(group)
            bucket = self._bucket_for(n)
            host = self._host_batch(bucket)
            frames = host.numpy()
            for i, p in enumerate(group):
                frames[i] = p.frame
            # pad by repeating frame 0: every lane stays a valid image
            frames[n:] = group[0].frame
            try:
                preds = self._run(host)
                for i, p in enumerate(group):
                    p.result = {k: v[i].copy() for k, v in preds.items()}
            except Exception as e:          # deliver, don't die
                with self._lock:
                    self.n_errors += 1
                for p in group:
                    p.error = e
            t1 = time.perf_counter()
            with self._lock:
                self.n_requests += n
                self.n_batches += 1
                self.batch_hist[bucket] += 1
                self.occupancy_sum += n
                for p in group:
                    self._latencies.append(t1 - p.t_submit)
            for p in group:
                p.event.set()

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies)
            q = (lambda f: lat[min(len(lat) - 1, int(f * len(lat)))]
                 if lat else None)
            return {
                "requests": self.n_requests,
                "batches": self.n_batches,
                "errors": self.n_errors,
                "batch_hist": dict(sorted(self.batch_hist.items())),
                "mean_occupancy": (self.occupancy_sum / self.n_batches
                                   if self.n_batches else None),
                "buckets": list(self.buckets),
                "max_delay_ms": self.max_delay * 1000.0,
                "latency_ms": {
                    "p50": None if not lat else round(q(0.50) * 1000, 2),
                    "p90": None if not lat else round(q(0.90) * 1000, 2),
                    "p99": None if not lat else round(q(0.99) * 1000, 2),
                },
            }
