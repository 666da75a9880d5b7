"""Image file reading: Pillow where it is installed, else ``data/png.py``;
and whether cv2 (the video source, the debug renders) is installed."""
from __future__ import annotations

import os

import numpy as np

from .png import read_png

__all__ = ["read_image", "have_pillow", "have_cv2"]


def have_pillow() -> bool:
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def have_cv2() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def read_image(path: str, size=None) -> np.ndarray:
    """Read an image as a uint8 array, (H, W) or (H, W, C).

    ``size`` = (W, H): resize with Pillow's default (bicubic) filter, as
    ``Image.resize`` does in the JAX package's datasets; a frame already at
    ``size`` is returned as read.  Without Pillow only PNGs can be read,
    and only at their own size.
    """
    if have_pillow():
        from PIL import Image

        with Image.open(path) as img:
            if size is not None:
                img = img.resize(tuple(size))
            return np.array(img)
    if os.path.splitext(path)[1].lower() != ".png":
        raise RuntimeError(f"{path}: reading this format needs Pillow, which "
                           "is not installed (only PNG is read without it)")
    arr = read_png(path)
    if size is not None and (arr.shape[1], arr.shape[0]) != tuple(size):
        raise RuntimeError(
            f"{path}: is {arr.shape[1]}x{arr.shape[0]}, resizing it to "
            f"{size[0]}x{size[1]} needs Pillow (bicubic), which is not "
            "installed")
    return arr
