"""Datasets (port of ``data/dataset.py``): ``BasicDataset`` on an image
directory, with the masks, UV maps, annotations and augmentation of
training, ``VideoDataset`` and ``split_on_train_val``.  cv2 is imported
only where it is used: the video source and the UV ``.tif`` masks.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .assets import resize_nearest_pil
from .image import read_image

__all__ = ["BasicDataset", "VideoDataset", "split_on_train_val", "preprocess_poi",
           "preprocess_weight", "preprocess_uv_mask", "aug_sample_seed"]

MAX_VALUE_UINT16 = np.iinfo(np.uint16).max


def split_on_train_val(img_dir: str, val_names: Sequence[str],
                       only_ncaam: bool = False) -> Tuple[List[str], List[str]]:
    """Split the game sub-directories of ``img_dir`` into train and
    validation ids ``game/frame.ext``."""
    names = [n for n in os.listdir(img_dir)
             if os.path.isdir(os.path.join(img_dir, n))]
    train_ids: List[str] = []
    val_ids: List[str] = []
    for name in names:
        subdir = os.path.join(img_dir, name)
        ids = [os.path.join(name, f) for f in os.listdir(subdir)
               if not f.endswith(".")]
        if name in val_names:
            val_ids += ids
        elif only_ncaam and name[0] == "2":
            print("Skip", name)
        else:
            train_ids += ids
    return train_ids, val_ids


def preprocess_poi(anno: np.ndarray):
    """(N, 3) annotation -> poi (N, 2), nonzeros (N,), num_nonzero."""
    anno = np.asarray(anno, dtype=np.float32)
    nonzeros = anno[:, 2]
    return anno[:, :2], nonzeros, np.float32(np.count_nonzero(nonzeros))


def preprocess_weight(reproj_mse) -> np.ndarray:
    """Annotation-quality weight: a shaped sigmoid of the reprojection MSE."""
    x = reproj_mse / 0.01
    x = x * 12 - 6
    x = x * 1.25 + 1
    y = 1 - 1 / (1 + np.exp(-x))
    return np.array([y], dtype=np.float32)


def preprocess_uv_mask(uv_mask: np.ndarray, target_size):
    """A (H, W, 3) uint16 UV ``.tif`` -> (labels (H, W) int64, uv (H, W, 2)
    float32 in [0, 1]), resized with cv2's ``INTER_NEAREST``."""
    import cv2

    if uv_mask.dtype != np.uint16:
        raise ValueError(f"a UV mask is uint16, not {uv_mask.dtype}")
    uv_mask = cv2.resize(uv_mask, dsize=tuple(target_size), interpolation=cv2.INTER_NEAREST)
    return (uv_mask[:, :, 0].astype(np.int64),
            (uv_mask[:, :, 1:3] / float(MAX_VALUE_UINT16)).astype(np.float32))


def aug_sample_seed(aug_seed: Optional[int], epoch: int, index: int) -> int:
    """The augmentation seed of sample ``index`` in ``epoch``: drawn from
    ``default_rng([aug_seed, epoch, index])``, so it does not depend on
    which loader thread reads the sample; without ``aug_seed``, from
    numpy's global generator (a different draw every run)."""
    if aug_seed is None:
        return int(np.random.randint(2147483647))
    return int(np.random.default_rng([int(aug_seed), int(epoch), int(index)])
               .integers(2147483647))


class BasicDataset:
    """Frames ``img_dir/<id>`` resized to ``target_size`` (W, H).  With
    ``raw_uint8`` (the default) frames stay uint8 and the division by 255
    happens on the device (bit-identical, and 4x fewer bytes to copy), as
    with the JAX package's ``raw_uint8``; else they are float32 in [0, 1].

    With ``mask_dir`` / ``anno_dir`` (training) a sample also carries
    ``mask`` ((H, W) int64 labels: a NEAREST-resized PNG, or with
    ``use_uv`` channel 0 of a uint16 ``.tif`` whose channels 1-2 give
    ``uv``, read with cv2), ``weight`` and, from the annotation JSON's
    ``anno_keys``, ``poi`` / ``nonzeros`` / ``num_nonzero`` and the
    ``reproj_mse`` weight.  ``keep_orig_img`` (the predict CLI's debug
    renders) adds ``orig_img``, the frame at its file's own size as
    (H, W, 3) uint8 BGR.

    ``aug`` (the conf's dict) augments each sample on its float image
    (``data/augmentation.py``) with the seed ``aug_sample_seed(aug_seed,
    epoch, index)``; ``set_epoch`` sets the epoch.  With ``raw_uint8`` the
    augmented image is rounded back to uint8.
    """

    def __init__(self, ids: Sequence[str], img_dir: str, target_size=(1280, 720),
                 mask_dir: Optional[str] = None, anno_dir: Optional[str] = None,
                 anno_keys: Optional[Sequence[str]] = None, keep_orig_img: bool = False,
                 use_uv: bool = False, aug=None, aug_seed: Optional[int] = None,
                 raw_uint8: bool = True):
        if anno_dir is not None and anno_keys is None:
            raise ValueError("anno_dir needs anno_keys")
        self.ids = list(ids)
        self.img_dir = img_dir
        self.target_size = tuple(target_size)
        self.mask_dir = mask_dir
        self.anno_dir = anno_dir
        self.anno_keys = list(anno_keys or [])
        self.keep_orig_img = keep_orig_img
        self.use_uv = use_uv
        self.raw_uint8 = raw_uint8
        self.aug_seed = aug_seed
        self._aug_epoch = 0
        self.aug = None
        if aug is not None:
            from .augmentation import AugmentationPipeline

            self.aug = AugmentationPipeline(aug, self.target_size, use_uv=use_uv)

    def __len__(self) -> int:
        return len(self.ids)

    def set_epoch(self, epoch: int) -> None:
        """The epoch of the per-sample augmentation seeds."""
        self._aug_epoch = int(epoch)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        name = self.ids[i]
        stem = name[: name.rfind(".")]
        img = read_image(os.path.join(self.img_dir, name), self.target_size)
        if img.ndim == 2:
            img = img[..., None]
        if self.aug is not None or not self.raw_uint8:
            img = img.astype(np.float32) / 255.0
        sample = {"name": stem}
        if self.keep_orig_img:
            orig = read_image(os.path.join(self.img_dir, name))
            # RGB(A) -> BGR, as cv2.cvtColor(COLOR_RGB2BGR); gray -> 3 channels
            sample["orig_img"] = np.ascontiguousarray(
                orig[..., 2::-1] if orig.ndim == 3 else np.repeat(orig[..., None], 3, -1))
        if self.mask_dir is None and self.anno_dir is None:
            sample["image"] = img
            return sample
        sample["weight"] = np.float32(1.0)
        mask = uv = poi = nonzeros = None
        if self.mask_dir is not None and self.use_uv:
            import cv2

            mask, uv = preprocess_uv_mask(
                cv2.imread(os.path.join(self.mask_dir, stem + ".tif"), -1), self.target_size)
        elif self.mask_dir is not None:
            mask = resize_nearest_pil(read_image(os.path.join(self.mask_dir, stem + ".png")),
                                      self.target_size).astype(np.int64)
        if self.anno_dir is not None:
            with open(os.path.join(self.anno_dir, stem + ".json")) as f:
                data = json.load(f)
            for k in self.anno_keys:
                anno = np.asarray(data[k], dtype="float")
                if k == "poi":
                    poi, nonzeros, sample["num_nonzero"] = preprocess_poi(anno)
                elif k == "reproj_mse":
                    sample["weight"] = preprocess_weight(anno)
                else:
                    sample[k] = anno.astype(np.float32)
        if self.aug is not None:
            img, mask, uv, poi, nonzeros = self.aug(
                img, mask, uv, poi, nonzeros,
                seed=aug_sample_seed(self.aug_seed, self._aug_epoch, i))
            if self.raw_uint8:
                img = np.clip(np.rint(img * 255.0), 0.0, 255.0).astype(np.uint8)
        sample["image"] = img
        for k, v in (("mask", mask), ("uv", uv), ("poi", poi), ("nonzeros", nonzeros)):
            if v is not None:
                sample[k] = v
        return sample


class VideoDataset:
    """Frames of a video file, decoded with cv2, as uint8 BGR at
    ``target_size`` (W, H) (cv2 ``INTER_AREA`` when shrinking, else
    ``INTER_LINEAR``), named ``<video>/<i:06d>``; with ``keep_orig_img``
    also the decoded frame itself (``orig_img``).

    ``__getitem__`` reads sequentially and expects in-order access (the
    Loader with one worker): a failed read seeks to the frame and retries,
    then gives a black frame.  ``decode_workers > 1`` decodes contiguous
    chunks of the range on as many threads (``_VideoDecodePool``), each
    capture seeked once, into an ordered buffer with a bounded
    decode-ahead window.  ``set_range`` restricts the frames read (resume).
    """

    def __init__(self, path: str, target_size=(640, 360), keep_orig_img: bool = False,
                 decode_workers: int = 1, decode_ahead: int = 64):
        import cv2

        self.cap = None
        self.path = path
        self.target_size = tuple(target_size)
        self.keep_orig_img = keep_orig_img
        t = os.path.basename(path)
        self.name = t[: t.rfind(".")]
        cap = cv2.VideoCapture(self.path)
        self.num_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        self.decode_workers = max(1, int(decode_workers))
        self.decode_ahead = max(self.decode_workers * 4, int(decode_ahead))
        self._pool = None
        self._range = (0, self.num_frames)

    def set_range(self, lo: int, hi: int) -> None:
        """Read only frames ``[lo, hi)``; call before the first access.  The
        sequential capture seeks to ``lo``; the decode pool chunks and
        windows only this range (from frame 0 it would wait forever on a
        window that the consumer never advances)."""
        import cv2

        lo = max(0, min(int(lo), self.num_frames))
        hi = max(lo, min(int(hi), self.num_frames))
        if self._pool is not None:
            raise RuntimeError("set_range must come before the first frame is read")
        self._range = (lo, hi)
        if self.decode_workers == 1 and lo:
            if self.cap is not None:
                self.cap.release()
            self.cap = cv2.VideoCapture(self.path)
            self.cap.set(cv2.CAP_PROP_POS_FRAMES, lo)

    def __len__(self) -> int:
        return self.num_frames

    @staticmethod
    def preprocess_frame(frame: np.ndarray, target_size) -> np.ndarray:
        """Resize a decoded frame to ``target_size`` (W, H): (H, W, C) uint8."""
        import cv2

        target_w, target_h = target_size
        h, w = frame.shape[:2]
        if w != target_w or h != target_h:
            inter = cv2.INTER_AREA if w > target_w else cv2.INTER_LINEAR
            frame = cv2.resize(frame, (target_w, target_h), interpolation=inter)
        if frame.ndim == 2:
            frame = frame[..., None]
        return frame

    def _read_with_fallback(self, cap, i: int) -> np.ndarray:
        """One sequential read; on failure seek to frame ``i`` and read
        again, then fall back to a black frame of the video's size."""
        import cv2

        ret, frame = cap.read()
        if ret is False:
            cap.set(cv2.CAP_PROP_POS_FRAMES, i)
            ret, frame = cap.read()
            if ret is False:
                w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
                h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
                frame = np.zeros((h, w, 3), dtype=np.uint8)
        return frame

    def _to_sample(self, frame: np.ndarray, i: int) -> Dict[str, np.ndarray]:
        sample = {"image": self.preprocess_frame(frame, self.target_size),
                  "name": self.name + "/" + str(i).zfill(6)}
        if self.keep_orig_img:
            sample["orig_img"] = frame
        return sample

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        import cv2

        if self.decode_workers > 1:
            if self._pool is None:
                self._pool = _VideoDecodePool(self)
            return self._pool.get(i)
        if self.cap is None:
            self.cap = cv2.VideoCapture(self.path)
        return self._to_sample(self._read_with_fallback(self.cap, i), i)

    def close(self) -> None:
        if self.cap is not None:
            self.cap.release()
            self.cap = None
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def __del__(self):
        self.close()


class _VideoDecodePool:
    """The chunked decoder behind ``VideoDataset.__getitem__`` when
    ``decode_workers > 1``.

    Worker w owns the frames ``[base + w * chunk, base + (w + 1) * chunk)``
    of the range, seeks its own capture once and reads on sequentially.
    Samples go into a dict under a condition variable; a worker waits once
    it holds ``decode_ahead / workers`` of its frames unconsumed, so every
    chunk decodes ahead in parallel in bounded memory.  ``get`` replays the
    last sample for the Loader's tail padding, which repeats the last index.
    """

    def __init__(self, ds: VideoDataset):
        self.ds = ds
        base, limit = ds._range
        self.n = limit - base
        self.cond = threading.Condition()
        self.ready: Dict[int, object] = {}
        self.next_needed = base       # lowest index not yet consumed
        self.last = None              # (i, sample): tail-padding replays
        self.error = None
        self.stop = False
        workers = min(ds.decode_workers, max(1, self.n))
        chunk = (self.n + workers - 1) // workers
        self.per_ahead = max(4, ds.decode_ahead // workers)
        self.threads = []
        for w in range(workers):
            lo, hi = base + w * chunk, min(base + (w + 1) * chunk, limit)
            if lo >= hi:
                break
            t = threading.Thread(target=self._decode_range, args=(lo, hi),
                                 daemon=True, name="sfh-video-decode")
            t.start()
            self.threads.append(t)

    def _decode_range(self, lo: int, hi: int) -> None:
        import cv2

        cap = None
        try:
            cap = cv2.VideoCapture(self.ds.path)
            if lo:
                cap.set(cv2.CAP_PROP_POS_FRAMES, lo)
            for i in range(lo, hi):
                sample = self.ds._to_sample(self.ds._read_with_fallback(cap, i), i)
                with self.cond:
                    while (self.error is None and not self.stop and
                           i - max(self.next_needed, lo) >= self.per_ahead):
                        self.cond.wait()
                    if self.error is not None or self.stop:
                        return
                    self.ready[i] = sample
                    self.cond.notify_all()
        except BaseException as e:      # handed to the consumers by get()
            with self.cond:
                self.error = e
                self.cond.notify_all()
        finally:
            if cap is not None:
                cap.release()

    def get(self, i: int):
        with self.cond:
            # the replay check stays inside the loop: when two consumers ask
            # for the same index (tail padding), the first pops ready[i] and
            # the second can only be served from self.last
            while True:
                if i in self.ready:
                    break
                if self.error is not None:
                    raise self.error
                if self.last is not None and self.last[0] == i:
                    return self.last[1]
                self.cond.wait()
            sample = self.ready.pop(i)
            self.last = (i, sample)
            if i >= self.next_needed:
                self.next_needed = i + 1
            self.cond.notify_all()
            return sample

    def close(self) -> None:
        """Stop and join the decode threads (each releases its capture)."""
        with self.cond:
            self.stop = True
            self.cond.notify_all()
        for t in self.threads:
            t.join(timeout=5.0)
