"""Host input pipeline: threaded decode, batches, copies to the device
(port of ``data/loader.py``).

By default batches keep one size: the tail batch is padded with copies of
its last sample and carries ``valid`` and ``num_valid`` (predict).
Training takes the true smaller tail batch (``pad_last=False``).  The
train shuffle's per-epoch order derives from ``(seed, epoch)`` as in the
JAX loader, and ``skip_next_batches`` starts an epoch part-way through
without reading what it skips (exact resume).  A data-parallel rank
(``shard=(rank, world)``) reads only its contiguous slice of each global
batch (``parallel/distributed.process_slice``: a ragged tail 3 + 2 over two
ranks), so the ranks together see exactly the samples, orders and
augmentation seeds one process would; a global batch with fewer samples
than ranks is skipped on every rank (``dropped`` counts them).
``device_prefetch`` replaces the JAX package's ``jax.device_put``
prefetch: it copies a batch's arrays through pinned host memory with
``non_blocking`` copies, keeping ``_IN_FLIGHT`` batches in flight so the
copy of the next batch overlaps the compute of this one.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..parallel.distributed import process_slice

__all__ = ["Loader", "device_prefetch"]

_READY_BATCHES = 2      # decoded batches waiting for the consumer
_IN_FLIGHT = 2          # batches copied to the device ahead of use
_HOST_KEYS = frozenset({"orig_img"})    # read on the host only (debug renders)


def _collate(samples) -> Dict[str, object]:
    batch: Dict[str, object] = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        batch[k] = (np.stack(vals) if isinstance(vals[0], (np.ndarray, np.generic))
                    else vals)
    return batch


class Loader:
    """Batch loader over an indexable dataset, in order or shuffled.

    Yields dicts of stacked numpy arrays (names as lists) plus ``valid``
    ((B,) bool) and ``num_valid`` (int).  Samples decode on a thread pool
    of ``num_workers``; at most ``_READY_BATCHES`` batches wait ready.
    With ``shuffle`` and a ``seed``, epoch e's order is a permutation drawn
    from ``np.random.default_rng([seed, e])`` (``set_epoch``, which also
    sets the dataset's augmentation epoch); with ``seed`` None, from one
    unseeded generator (a different order every run).
    """

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 shuffle: bool = False, seed: Optional[int] = None,
                 pad_last: bool = True, shard: Optional[Tuple[int, int]] = None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.num_workers = max(1, int(num_workers))
        self.shuffle = shuffle
        self.seed = seed
        self.pad_last = pad_last
        self._epoch = 0
        self._skip = 0
        self._rng = np.random.default_rng(seed)
        self.shard = shard
        self.dropped = 0

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def skip_next_batches(self, k: int) -> None:
        """The next pass starts ``k`` batches into the epoch; the skipped
        samples are not read."""
        self._skip = max(0, int(k))

    def _order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = (self._rng if self.seed is None
                   else np.random.default_rng([int(self.seed), self._epoch]))
            rng.shuffle(order)
        return order

    def _batches_of_indices(self):
        order, bs = self._order(), self.batch_size
        first, self._skip = self._skip * bs, 0
        for start in range(first, len(order), bs):
            idx = order[start:start + bs]
            valid = np.ones(len(idx), bool)
            pad = bs - len(idx) if self.pad_last else 0
            if pad:
                idx = np.concatenate([idx, np.full(pad, idx[-1])])
                valid = np.concatenate([valid, np.zeros(pad, bool)])
            if self.shard is not None:
                rank, world = self.shard
                if len(idx) < world:
                    self.dropped += 1
                    continue
                lo, size = process_slice(len(idx), rank, world)
                idx, valid = idx[lo:lo + size], valid[lo:lo + size]
            yield idx, valid

    def __iter__(self) -> Iterator[Dict[str, object]]:
        out_q: "queue.Queue" = queue.Queue(maxsize=_READY_BATCHES)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                    for idx, valid in self._batches_of_indices():
                        samples = list(ex.map(self.dataset.__getitem__, idx))
                        batch = _collate(samples)
                        batch["valid"] = valid
                        batch["num_valid"] = int(valid.sum())
                        if not put(batch):
                            return
                put(None)
            except BaseException as e:  # handed to the consumer, re-raised there
                if put(e):
                    put(None)

        t = threading.Thread(target=producer, daemon=True,
                             name="sfh-loader-producer")
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=5)


def device_prefetch(iterator, device: torch.device):
    """Copy each batch's numpy arrays to ``device`` ahead of use (other
    entries, such as names, and the host-only ``_HOST_KEYS`` pass through).

    On a CUDA device they go through pinned memory with ``non_blocking``
    copies on the current stream, so ``_IN_FLIGHT`` batches are on their
    way while the caller computes.
    """
    device = torch.device(device)
    pin = device.type == "cuda"

    def put(batch):
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and k not in _HOST_KEYS:
                t = torch.from_numpy(v)
                if pin:
                    t = t.pin_memory()
                batch[k] = t.to(device, non_blocking=pin)
        return batch

    buf = []
    it = iter(iterator)
    for batch in it:
        buf.append(put(batch))
        if len(buf) == _IN_FLIGHT:
            break
    while buf:
        out = buf.pop(0)
        nxt = next(it, None)
        if nxt is not None:
            buf.append(put(nxt))
        yield out

