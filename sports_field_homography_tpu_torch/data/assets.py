"""Court template loader (port of ``data/assets.py``).

The JAX package keeps the template as floats ``label / num_classes``; the
port keeps the (H, W) uint8 labels themselves, which is what the warp
kernel reads (``ops/warp.py``).
"""
from __future__ import annotations

import numpy as np

from .image import read_image

__all__ = ["open_court_template", "resize_nearest_pil"]


def _pil_nearest_index(src: int, dst: int) -> np.ndarray:
    """Source indices of Pillow's NEAREST resize along one axis.

    Pillow walks the output with a float64 position that starts at half a
    source step and adds one step per pixel, taking ``int(position)``;
    ``np.cumsum`` adds in the same order, so the indices match bit for bit.
    """
    step = src / dst
    pos = np.cumsum(np.concatenate([[step * 0.5], np.full(dst - 1, step)]))
    return np.minimum(pos.astype(np.int64), src - 1)


def resize_nearest_pil(img: np.ndarray, size) -> np.ndarray:
    """NEAREST resize of an (H, W[, C]) array to ``size`` = (W, H), equal
    to ``PIL.Image.resize(size, resample=Image.NEAREST)``."""
    w, h = int(size[0]), int(size[1])
    if img.shape[0] == h and img.shape[1] == w:
        return img.copy()
    rows = _pil_nearest_index(img.shape[0], h)
    cols = _pil_nearest_index(img.shape[1], w)
    return img[rows[:, None], cols[None, :]]


def open_court_template(path: str, num_classes: int, size=None) -> np.ndarray:
    """Load the court template as (H, W) uint8 class labels.

    ``size`` is (W, H); the NEAREST resize keeps the labels.  An RGB-saved
    template contributes its first channel.  ``labels / num_classes`` is
    the JAX package's ``open_court_template`` (batch and channel axes aside).
    """
    arr = read_image(path)
    if arr.ndim == 3:
        arr = arr[..., 0]
    if size is not None:
        arr = resize_nearest_pil(arr, size)
    labels = arr.astype(np.uint8)
    if labels.max(initial=0) >= num_classes:
        raise ValueError(f"{path}: label {labels.max()} >= {num_classes} classes")
    return labels
