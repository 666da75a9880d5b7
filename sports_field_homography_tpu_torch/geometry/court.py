"""Court constants, template and PoI loaders, per-frame homography mapping
and a nearest warper for host images (port of ``geometry/court.py``).

Everything but ``Warper`` is numpy (and cv2 for ``load_court_mask``,
imported where it is called) on the host.  ``Warper.warp`` runs on the card
unless its caller asks for the CPU.
"""
from __future__ import annotations

import json

import numpy as np

__all__ = ["Warper", "CourtSizes", "FrameMapping", "CourtMapping", "load_court_mask",
           "load_court_poi", "generate_uv_template", "transform_poi_np",
           "map_frame_to_court", "map_court_to_frame"]


class CourtSizes:
    """Court dimension constants."""

    COURT_IN_PIXELS = (1280, 720)
    FRAME_IN_PIXELS = (1280, 720)
    COURT_IN_METERS = (32.2326, 17.145)
    METERS2FEET = 3.28084
    METERS2PIXELS = (COURT_IN_PIXELS[0] / COURT_IN_METERS[0],
                     COURT_IN_PIXELS[1] / COURT_IN_METERS[1])
    PIXELS2METERS = (COURT_IN_METERS[0] / COURT_IN_PIXELS[0],
                     COURT_IN_METERS[1] / COURT_IN_PIXELS[1])


class FrameMapping:
    """Per-frame homographies and prediction score."""

    def __init__(self, theta_f2c: np.ndarray, theta_c2f: np.ndarray, score: float):
        self.theta_f2c = theta_f2c      # frame -> court
        self.theta_c2f = theta_c2f      # court -> frame
        self.score = score


class CourtMapping:
    """A ``{game}_court.json`` prediction file as per-frame thetas: the
    ``model`` entry is popped (and its name printed), each frame's
    ``theta[0]`` is frame -> court and its inverse court -> frame."""

    def __init__(self, path: str):
        with open(path, "r") as f:
            raw = json.load(f)
        self.frames = {}
        if "model" in raw:
            model_name = raw.pop("model")
            print("Court homography was predicted by the {} model".format(model_name))
        for frame_id, data in raw.items():
            score = float(data["score"])
            theta_f2c = np.array(data["theta"])[0]
            theta_c2f = np.linalg.inv(theta_f2c)
            self.frames[frame_id] = FrameMapping(theta_f2c, theta_c2f, score)


def load_court_mask(path: str, court_size, inter=None) -> np.ndarray:
    """Load a court image with cv2 (BGR) and resize it to ``court_size``
    (W, H): ``INTER_AREA`` when shrinking, else ``INTER_CUBIC``, unless
    ``inter`` says otherwise."""
    import cv2

    court_mask = cv2.imread(path, cv2.IMREAD_COLOR)
    if court_mask.shape[0] != court_size[1] or court_mask.shape[1] != court_size[0]:
        if inter is None:
            inter = cv2.INTER_AREA if court_mask.shape[1] > court_size[0] else cv2.INTER_CUBIC
        court_mask = cv2.resize(court_mask, tuple(court_size), interpolation=inter)
    return court_mask


def load_court_poi(path: str, normalize: bool = True,
                   homogeneous: bool = False) -> np.ndarray:
    """Load court points of interest from JSON as (N, 2), or (N, 3) with a
    1 appended when ``homogeneous``.  The JSON stores them in [0, 1];
    ``normalize`` maps them to [-1, 1]."""
    try:
        with open(path) as f:
            data = json.load(f)
        if data["ranges"][0] != 1.0 or data["ranges"][1] != 1.0:
            raise ValueError(f"ranges {data['ranges']} are not [1.0, 1.0]")
        points = []
        for p in data["points"]:
            if normalize:
                x, y = (p["coords"][0] - 0.5) * 2, (p["coords"][1] - 0.5) * 2
            else:
                x, y = p["coords"][0], p["coords"][1]
            points.append((x, y, 1.0) if homogeneous else (x, y))
        return np.array(points)
    except (OSError, KeyError, IndexError, TypeError, ValueError) as e:
        raise ValueError(f"Cannot read {path}: {e}") from e


def generate_uv_template(size, dtype=np.float32, x_offset=(0, 0), y_offset=(0, 0)):
    """(u, v) coordinate ramps of shape (H, W) for ``size`` = (W, H).

    Float dtypes ramp over (1/N .. 1], uint16 and int16 over [1 .. N].
    Pixels outside the trimmed interior are 0: each axis drops
    ``offset[0]`` leading and ``offset[1] + 1`` trailing pixels.
    """
    w, h = int(size[0]), int(size[1])
    dt = np.dtype(dtype)
    if dt.kind == "f":
        u_ramp = np.linspace(1.0 / w, 1.0, num=w, dtype=dt)
        v_ramp = np.linspace(1.0 / h, 1.0, num=h, dtype=dt)
    elif dt in (np.dtype(np.uint16), np.dtype(np.int16)):
        u_ramp = np.linspace(1, w, num=w, dtype=dt)
        v_ramp = np.linspace(1, h, num=h, dtype=dt)
    else:
        raise NotImplementedError(dt)
    col_keep = np.zeros(w, bool)
    col_keep[x_offset[0]:w - x_offset[1] - 1] = True
    row_keep = np.zeros(h, bool)
    row_keep[y_offset[0]:h - y_offset[1] - 1] = True
    keep = row_keep[:, None] & col_keep[None, :]
    u = np.where(keep, u_ramp[None, :], 0).astype(dt)
    v = np.where(keep, v_ramp[:, None], 0).astype(dt)
    return u, v


def transform_poi_np(theta: np.ndarray, poi: np.ndarray,
                     normalize: bool = False) -> np.ndarray:
    """Perspective transform of (N, 2) points by a 3x3 theta in float64;
    ``normalize`` maps the result from [-1, 1] to [0, 1]."""
    pts = np.asarray(poi, dtype=np.float64)
    ph = np.concatenate([pts, np.ones((pts.shape[0], 1), dtype=pts.dtype)], axis=1)
    out = ph @ np.asarray(theta, dtype=pts.dtype).T
    proj = out[:, :2] / out[:, 2:3]
    if normalize:
        proj = proj / 2.0 + 0.5
    return proj


def _to_normalized(loc, size):
    if not isinstance(loc, np.ndarray):
        loc = np.array([loc], dtype=np.float32)
    loc = loc.astype(np.float64, copy=True)
    if size is not None:
        loc[:, 0] = (loc[:, 0] / size[0] - 0.5) * 2.0
        loc[:, 1] = (loc[:, 1] / size[1] - 0.5) * 2.0
    return loc


def map_frame_to_court(theta_f2c, frame_loc, frame_size=None):
    """Frame locations (pixels when ``frame_size`` = (W, H) is given, else
    [-1, 1]) -> [0, 1] court coordinates."""
    return transform_poi_np(theta_f2c, _to_normalized(frame_loc, frame_size), normalize=True)


def map_court_to_frame(theta_c2f, court_loc, court_size=None):
    """Court locations (pixels when ``court_size`` = (W, H) is given, else
    [-1, 1]) -> [0, 1] frame coordinates."""
    return transform_poi_np(theta_c2f, _to_normalized(court_loc, court_size), normalize=True)


class Warper:
    """Nearest homography warp of a host image to ``size`` = (W, H).

    ``warp(theta, proj)`` takes an (H, W, C) image and a 3x3 frame ->
    court theta (numpy) and returns the (H', W', C) float32 warp as numpy,
    0 outside the image (``geometry/warp.warp_nearest_image``).  It runs
    on the card (``cuda`` None or true), or on the CPU when ``cuda`` is
    false.
    """

    def __init__(self, size, cuda=None):
        import torch

        self.size = tuple(size)
        self.device = torch.device("cpu" if cuda is not None and not cuda else "cuda")

    def warp(self, theta: np.ndarray, proj: np.ndarray) -> np.ndarray:
        import torch

        from .warp import warp_nearest_image

        w, h = self.size
        img = torch.from_numpy(np.asarray(proj, np.float32)).to(self.device)[None]
        th = torch.from_numpy(np.asarray(theta, np.float32)).to(self.device)[None]
        return warp_nearest_image(img, th, (h, w))[0].cpu().numpy()
