"""A seeded synthetic training set: court-template renders under
broadcast-camera homographies (port of ``scripts/make_synthetic_dataset.py``
without Pillow or JAX).

Layout ``<dst>/{frames,masks,anno}/<game>/<nnnnnn>.{png,png,json}``: RGB
frames, L-mode label masks (the template nearest-warped by theta, so the
ground truth is exact), and annotations with the projected court points
(``poi``: (N, 3) rows of x, y in [0, 1] and a visibility flag) and
``reproj_mse``.  The games are ``train_game`` and ``val_game``.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..geometry.court import load_court_poi
from ..geometry.homography import transform_poi
from ..ops.warp import warp_nearest_plain
from .assets import open_court_template
from .png import write_png

__all__ = ["write_synthetic_dataset", "synthetic_samples", "sample_theta"]

BASE_THETA = np.array([[1.4, 0.1, 0.05], [0.02, 2.2, 0.6], [0.01, 0.9, 1.0]])
# class colours of the rendered frames (background, floor, lines, paint)
_PALETTE = np.array([[20, 30, 20], [200, 160, 110], [250, 250, 250],
                     [150, 50, 40]], np.float32)


def sample_theta(rng: np.random.RandomState) -> np.ndarray:
    n = rng.randn(3, 3) * np.array([[.15, .05, .1], [.05, .3, .15],
                                    [.005, .1, .05]])
    return (BASE_THETA + n).astype(np.float32)


def synthetic_samples(n: int, court_img: str, court_poi: str, size=(640, 360),
                      classes: int = 4, rng: np.random.RandomState = None):
    """``n`` samples as arrays: frames (n, H, W, 3) uint8, label masks
    (n, H, W) uint8 and annotations (n, N, 3) float64 (x, y in [0, 1] and
    a visibility flag)."""
    w, h = size
    rng = rng if rng is not None else np.random.RandomState(0)
    tmpl = torch.from_numpy(open_court_template(court_img, classes, size=(w, h)))
    poi = torch.from_numpy(load_court_poi(court_poi).astype(np.float32))
    thetas = torch.from_numpy(np.stack([sample_theta(rng) for _ in range(n)]))
    identity = torch.arange(256, dtype=torch.float32)       # each label's value is itself
    labels = warp_nearest_plain(tmpl, thetas, (h, w), identity).numpy().astype(np.uint8)
    pts = transform_poi(thetas, poi).numpy().astype(np.float64)
    ramp = np.linspace(0, 40, h, dtype=np.float32)[:, None, None]
    frames = np.stack([np.clip(_PALETTE[labels[i]] * 0.7 + 40 + ramp
                               + rng.randn(h, w, 3) * 12, 0, 255) for i in range(n)])
    visible = ((pts[..., 0] > 0) & (pts[..., 0] < 1) & (pts[..., 1] > 0)
               & (pts[..., 1] < 1))
    anno = np.concatenate([np.clip(pts, 0, 1), visible[..., None].astype(np.float64)], -1)
    return frames.astype(np.uint8), labels, anno


def write_synthetic_dataset(dst: str, n_train: int, n_val: int, court_img: str,
                            court_poi: str, size=(640, 360), classes: int = 4,
                            seed: int = 0) -> None:
    """Write ``n_train`` + ``n_val`` samples of ``size`` (W, H) to ``dst``."""
    rng = np.random.RandomState(seed)
    idx = 0
    for game, count in (("train_game", n_train), ("val_game", n_val)):
        for d in ("frames", "masks", "anno"):
            os.makedirs(os.path.join(dst, d, game), exist_ok=True)
        if count == 0:
            continue
        frames, labels, anno = synthetic_samples(count, court_img, court_poi, size,
                                                 classes, rng)
        for i in range(count):
            name = f"{idx:06d}"
            write_png(os.path.join(dst, "frames", game, name + ".png"), frames[i])
            write_png(os.path.join(dst, "masks", game, name + ".png"), labels[i])
            with open(os.path.join(dst, "anno", game, name + ".json"), "w") as f:
                json.dump({"poi": anno[i].tolist(), "reproj_mse": 0.0001}, f)
            idx += 1
