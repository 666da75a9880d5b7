"""Offline dataset-preparation pipeline (port of ``prep/preparation.py``,
numpy and cv2 on the host).

Steps: generate requests from manual annotations, fit the homography from >=4 manual PoI, project field PoI,
compute reprojection RMSE, build segmentation masks from the template +
theta, and convert RGB masks to one-hot label images.

The homography fit offers both the OpenCV path (``cv2.findHomography``,
what the reference uses) and a dependency-free normalized-DLT
implementation (``find_homography_dlt``) with equivalent least-squares
behavior for the all-inlier case.
"""
from __future__ import annotations

import json
import os
from multiprocessing import cpu_count, get_context

import numpy as np

__all__ = [
    "FOOTBALL_PITCH_IGNORE_POINTS",
    "generate_requests",
    "calculate_homography",
    "find_homography_dlt",
    "find_nonzero_points",
    "calculate_reprojection_rmse",
    "rescale_theta",
    "generate_onehot",
    "convert_rgb_to_onehot",
    "MASK_CLASS_MAPPINGS",
]

FOOTBALL_PITCH_IGNORE_POINTS = [12, 13, 16, 19, 20]

# id -> (r, g, b) label colors (reference ``generate_onehot``, :216-238)
MASK_CLASS_MAPPINGS = {
    4: {1: (0, 255, 0), 2: (255, 0, 0), 3: (0, 0, 255)},
    7: {1: (0, 255, 0), 2: (255, 0, 0), 3: (0, 0, 255), 4: (255, 255, 255),
        5: (255, 0, 255), 6: (0, 255, 255)},
    8: {1: (0, 255, 0), 2: (255, 0, 0), 3: (0, 0, 255), 4: (255, 255, 255),
        5: (255, 0, 255), 6: (0, 255, 255), 7: (255, 255, 0)},
}


def generate_requests(anno_dir: str):
    """Collect per-game manual annotation requests (reference :36-66)."""
    requests = {}
    names = [n for n in os.listdir(anno_dir)
             if os.path.isdir(os.path.join(anno_dir, n))]
    for name in names:
        with open(os.path.join(anno_dir, name, "manual_anno.json"), "r") as f:
            game_anno = json.load(f)
        game_requests = {}
        for frame_id, values in game_anno.items():
            game_requests[frame_id] = {
                "manual_poi": np.array(values["poi"]),
                "poi": None,
                "theta": None,
                "rmse": values.get("rmse"),
            }
        requests[name] = game_requests
    return requests


def find_homography_dlt(src_pts: np.ndarray, dst_pts: np.ndarray):
    """Least-squares homography by normalized DLT (Hartley normalization).

    Native twin of ``cv2.findHomography(method=0)`` for all-inlier input.
    """
    src = np.asarray(src_pts, np.float64)
    dst = np.asarray(dst_pts, np.float64)
    assert src.shape == dst.shape and src.shape[0] >= 4

    def normalize(p):
        c = p.mean(axis=0)
        d = np.sqrt(((p - c) ** 2).sum(axis=1)).mean()
        s = np.sqrt(2) / max(d, 1e-12)
        T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1]])
        ph = np.concatenate([p, np.ones((p.shape[0], 1))], axis=1) @ T.T
        return ph[:, :2], T

    s_n, Ts = normalize(src)
    d_n, Td = normalize(dst)
    n = src.shape[0]
    A = np.zeros((2 * n, 9))
    for i in range(n):
        x, y = s_n[i]
        u, v = d_n[i]
        A[2 * i] = [-x, -y, -1, 0, 0, 0, u * x, u * y, u]
        A[2 * i + 1] = [0, 0, 0, -x, -y, -1, v * x, v * y, v]
    _, _, vt = np.linalg.svd(A)
    Hn = vt[-1].reshape(3, 3)
    H = np.linalg.inv(Td) @ Hn @ Ts
    return H / H[2, 2]


def calculate_homography(field_poi: np.ndarray, manual_poi: np.ndarray,
                         use_cv2: bool = True):
    """Fit theta from manually annotated PoI (reference :69-92); returns
    None with fewer than 4 valid correspondences."""
    assert field_poi.shape[0] == manual_poi.shape[0]
    pts_from, pts_to = [], []
    for i, (x, y) in enumerate(manual_poi):
        if x != -1.0 and y != -1.0:
            pts_from.append(field_poi[i])
            pts_to.append(manual_poi[i])
    if len(pts_from) < 4:
        return None
    if use_cv2:
        import cv2

        theta, _ = cv2.findHomography(np.array(pts_from), np.array(pts_to))
        return theta
    return find_homography_dlt(np.array(pts_from), np.array(pts_to))


def find_nonzero_points(poi, ignore_pts=None):
    """Valid-point mask; (-1,-1) and ignored indices are dropped
    (reference :95-104)."""
    if ignore_pts is None:
        ignore_pts = []
    nonzero = np.ones(poi.shape[0], dtype=bool)
    for i, (x, y) in enumerate(poi):
        if i in ignore_pts or (x == -1.0 and y == -1.0):
            nonzero[i] = False
    return nonzero


def calculate_reprojection_rmse(pts1, pts2, nonzero=None, norm_size=None):
    """Masked mean point distance (reference :107-126)."""
    p1 = np.copy(pts1)
    p2 = np.copy(pts2)
    if norm_size is not None:
        p1[:, 0] *= norm_size[0]
        p1[:, 1] *= norm_size[1]
        p2[:, 0] *= norm_size[0]
        p2[:, 1] *= norm_size[1]
    if nonzero is None:
        nonzero = np.ones(p1.shape[0], dtype=bool)
    dist = np.sqrt(np.sum(np.power(p1 - p2, 2), axis=1))
    num_nonzero = np.count_nonzero(nonzero, axis=0)
    return np.sum(dist * nonzero, axis=0) / num_nonzero


def rescale_theta(src_size, dst_size, theta):
    """Pixel-space homography rescale (reference :129-137)."""
    dst_scale = np.array([[dst_size[0], 0, 0], [0, dst_size[1], 0], [0, 0, 1]],
                         dtype=np.float64)
    src_scale_inv = np.array([[1 / src_size[0], 0, 0], [0, 1 / src_size[1], 0],
                              [0, 0, 1]], dtype=np.float64)
    return dst_scale @ np.asarray(theta, np.float64) @ src_scale_inv


def _convert_one(path_and_mapping):
    import cv2

    path, mapping = path_and_mapping
    mask = cv2.imread(path, 1)
    out = np.zeros(mask.shape[:2], dtype=np.uint8)
    for cid, color in mapping.items():
        out[np.all(mask == color, axis=2)] = cid
    cv2.imwrite(path, out)
    return path


def convert_rgb_to_onehot(mask_dir, mapping, num_workers=None):
    """RGB class-color masks -> grayscale label masks, in-place, on
    ``num_workers`` spawned processes (reference :140-213)."""
    paths = []
    for dirpath, _, filenames in os.walk(mask_dir):
        for filename in filenames:
            if filename.endswith(".png"):
                paths.append(os.path.join(dirpath, filename))
    if num_workers is None:
        num_workers = cpu_count()
    # spawned workers: a forked child of a process with threads (torch's)
    # can deadlock
    with get_context("spawn").Pool(num_workers) as pool:
        pool.map(_convert_one, [(p, mapping) for p in paths])
    print("Done! Processed masks:", len(paths))
    return len(paths)


def generate_onehot(mask_dir, num_classes=8, num_workers=None):
    if num_classes not in MASK_CLASS_MAPPINGS:
        raise NotImplementedError(num_classes)
    return convert_rgb_to_onehot(mask_dir, MASK_CLASS_MAPPINGS[num_classes],
                                 num_workers)
