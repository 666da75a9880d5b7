"""A seeded synthetic training set: court-template renders under
broadcast-camera homographies (port of ``scripts/make_synthetic_dataset.py``
without Pillow or JAX).

Layout ``<dst>/{frames,masks,anno}/<game>/<nnnnnn>.{png,png,json}``: RGB
frames, L-mode label masks (the template nearest-warped by theta, so the
ground truth is exact), and annotations with the projected court points
(``poi``: (N, 3) rows of x, y in [0, 1] and a visibility flag) and
``reproj_mse``.  The games are ``train_game`` and ``val_game``.

A court image drawn in class colours (the soccer pitch's
``assets/pitch_mask_nc4_hd.png``, RGBA) is first converted to a label
template by ``prep/preparation.MASK_CLASS_MAPPINGS``, as the JAX
package's script does, and written to ``<dst>/court_template_onehot.png``:
the train and predict CLIs take that file as ``court_img``.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..geometry.court import load_court_poi
from ..geometry.homography import transform_poi
from ..ops.warp import warp_nearest_plain
from ..prep.preparation import MASK_CLASS_MAPPINGS
from .assets import open_court_template
from .image import read_image
from .png import write_png

__all__ = ["write_synthetic_dataset", "synthetic_samples", "sample_theta",
           "court_labels_from_colors", "label_template"]

ONEHOT_NAME = "court_template_onehot.png"

BASE_THETA = np.array([[1.4, 0.1, 0.05], [0.02, 2.2, 0.6], [0.01, 0.9, 1.0]])
# class colours of the rendered frames (background, floor, lines, paint)
_PALETTE = np.array([[20, 30, 20], [200, 160, 110], [250, 250, 250],
                     [150, 50, 40]], np.float32)


def sample_theta(rng: np.random.RandomState) -> np.ndarray:
    n = rng.randn(3, 3) * np.array([[.15, .05, .1], [.05, .3, .15],
                                    [.005, .1, .05]])
    return (BASE_THETA + n).astype(np.float32)


def _rgb(arr: np.ndarray) -> np.ndarray:
    """An 8-bit L, LA, RGB or RGBA image as RGB, as Pillow's
    ``convert("RGB")`` gives it (gray replicated, alpha dropped)."""
    if arr.ndim == 2:
        return np.repeat(arr[..., None], 3, axis=2)
    if arr.shape[2] == 2:
        return np.repeat(arr[..., :1], 3, axis=2)
    return arr[..., :3]


def court_labels_from_colors(court_img: str, classes: int = 4):
    """The court image's (H, W) uint8 labels (read with Pillow where it is
    installed, else ``data/png.py``) and whether it was drawn in
    class colours: an image with more distinct colours than classes, or a
    channel range above the class count, maps each colour of
    ``MASK_CLASS_MAPPINGS[classes]`` to its class and the rest to 0; any
    other image is already label-coded (its first channel)."""
    arr = read_image(court_img)
    raw = _rgb(arr)
    if arr.ndim == 2:           # gray: its colours are its values
        n_colors = int((np.bincount(arr.ravel(), minlength=256) > 0).sum())
    else:
        codes = raw.astype(np.int32)
        n_colors = len(np.unique((codes[..., 0] << 16) | (codes[..., 1] << 8) | codes[..., 2]))
    if n_colors > classes or np.ptp(raw) > classes:
        labels = np.zeros(raw.shape[:2], np.uint8)
        for cid, color in MASK_CLASS_MAPPINGS[classes].items():
            labels[np.all(raw == color, axis=2)] = cid
        if labels.max() == 0:
            raise ValueError(f"no mapped class colors found in {court_img}")
        return labels, True
    return (arr if arr.ndim == 2 else arr[..., 0]), False


def label_template(court_img: str, classes: int, dst: str) -> str:
    """The path of a label-coded template for ``court_img``: itself, or
    its conversion from class colours written to ``dst/court_template_onehot.png``."""
    labels, converted = court_labels_from_colors(court_img, classes)
    if not converted:
        return court_img
    os.makedirs(dst, exist_ok=True)
    path = os.path.join(dst, ONEHOT_NAME)
    write_png(path, labels)
    return path


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
                            seed: int = 0) -> str:
    """Write ``n_train`` + ``n_val`` samples of ``size`` (W, H) to ``dst``;
    returns the label template they were rendered from (``label_template``)."""
    court_img = label_template(court_img, classes, dst)
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
    return court_img
