"""Image-directory datasets (port of ``data/dataset.py``: ``BasicDataset``
on the image path, with the masks and annotations of training, and
``split_on_train_val``).  Augmentation, UV ``.tif`` masks and video come
later (ROADMAP.md queue 1).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .assets import resize_nearest_pil
from .image import read_image

__all__ = ["BasicDataset", "split_on_train_val", "preprocess_poi",
           "preprocess_weight"]


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


class BasicDataset:
    """Frames ``img_dir/<id>`` resized to ``target_size`` (W, H), as uint8:
    the division by 255 happens on the device (bit-identical, and 4x fewer
    bytes to copy), as with the JAX package's ``raw_uint8``.

    With ``mask_dir`` / ``anno_dir`` (training) a sample also carries
    ``mask`` ((H, W) int64 labels, PNG, NEAREST-resized), ``weight`` and,
    from the annotation JSON's ``anno_keys``, ``poi`` / ``nonzeros`` /
    ``num_nonzero`` and the ``reproj_mse`` weight.
    """

    def __init__(self, ids: Sequence[str], img_dir: str, target_size=(1280, 720),
                 mask_dir: Optional[str] = None, anno_dir: Optional[str] = None,
                 anno_keys: Optional[Sequence[str]] = None):
        if anno_dir is not None and anno_keys is None:
            raise ValueError("anno_dir needs anno_keys")
        self.ids = list(ids)
        self.img_dir = img_dir
        self.target_size = tuple(target_size)
        self.mask_dir = mask_dir
        self.anno_dir = anno_dir
        self.anno_keys = list(anno_keys or [])

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        name = self.ids[i]
        stem = name[: name.rfind(".")]
        img = read_image(os.path.join(self.img_dir, name), self.target_size)
        if img.ndim == 2:
            img = img[..., None]
        sample = {"name": stem, "image": img}
        if self.mask_dir is None and self.anno_dir is None:
            return sample
        sample["weight"] = np.float32(1.0)
        if self.mask_dir is not None:
            mask = read_image(os.path.join(self.mask_dir, stem + ".png"))
            sample["mask"] = resize_nearest_pil(mask, self.target_size).astype(np.int64)
        if self.anno_dir is not None:
            with open(os.path.join(self.anno_dir, stem + ".json")) as f:
                data = json.load(f)
            for k in self.anno_keys:
                anno = np.asarray(data[k], dtype="float")
                if k == "poi":
                    (sample["poi"], sample["nonzeros"],
                     sample["num_nonzero"]) = preprocess_poi(anno)
                elif k == "reproj_mse":
                    sample["weight"] = preprocess_weight(anno)
                else:
                    sample[k] = anno.astype(np.float32)
        return sample
