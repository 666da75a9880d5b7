"""Image-directory dataset for prediction (port of ``data/dataset.py``'s
``BasicDataset`` on the image-only path; masks, annotations, augmentation
and video come with training and the video source, ROADMAP.md queue 1).
"""
from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

from .image import read_image

__all__ = ["BasicDataset"]


class BasicDataset:
    """Frames ``img_dir/<id>`` resized to ``target_size`` (W, H), as uint8:
    the division by 255 happens on the device (bit-identical, and 4x fewer
    bytes to copy), as with the JAX package's ``raw_uint8``.
    """

    def __init__(self, ids: Sequence[str], img_dir: str, target_size=(1280, 720)):
        self.ids = list(ids)
        self.img_dir = img_dir
        self.target_size = tuple(target_size)

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        name = self.ids[i]
        img = read_image(os.path.join(self.img_dir, name), self.target_size)
        if img.ndim == 2:
            img = img[..., None]
        return {"name": name[: name.rfind(".")], "image": img}
