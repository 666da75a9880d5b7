"""End-to-end dataset preparation script (port of ``prep/build_dataset.py``;
numpy and cv2 on the host, the mask PNGs through Pillow where it is
installed, else ``data/png.py``).

Script equivalent of the reference's notebooks
(``dataset_utils/football_dataset.ipynb`` / ``center_court_dataset.ipynb``)
over the documented pipeline (reference ``dataset_utils/preparation.py:1-15``):

  1. read per-game ``manual_anno.json`` requests;
  2. fit theta from >=4 manually annotated PoI (normalized [0,1] coords);
  3. project the field PoI into the frame;
  4. compute the reprojection RMSE (normalized + optionally pixel units);
  5. render the segmentation mask by warping the court template with theta;
  6. save per-frame ``{poi, theta, reproj_mse}`` JSON + mask PNGs;
  7. (``--uv``) generate UV-masks, merge them with the segmentation masks
     and save them as uint16 3-channel tiffs — notebook step 9
     (``dataset_utils/football_dataset.ipynb`` cell 15, building on
     reference ``utils/court.py:102-129``).  These are the inputs the
     ``unet_uv`` training path reads back via
     ``data.dataset.preprocess_uv_mask``.

Usage:
  python -m sports_field_homography_tpu_torch.prep.build_dataset \
      --anno_dir <dir-with-<game>/manual_anno.json> \
      --field_poi assets/template_ncaa_v4_points.json \
      --field_mask assets/mask_ncaa_v4_nc4_m_onehot.png \
      --dst_dir <out> [--mask_size 1280 720] [--ignore_pts 12,13,...]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data.image import have_pillow, read_image
from ..data.png import write_png
from ..geometry.court import generate_uv_template, load_court_poi
from .preparation import (
    calculate_homography,
    calculate_reprojection_rmse,
    find_nonzero_points,
    generate_requests,
)

__all__ = ["build_dataset", "build_uv_masks", "main"]


def _save_png(path: str, img: np.ndarray) -> None:
    """Pillow's PNG where it is installed, else ``data/png.write_png``."""
    if have_pillow():
        from PIL import Image

        Image.fromarray(img).save(path)
    else:
        write_png(path, img)


def _project_poi(theta: np.ndarray, poi01: np.ndarray) -> np.ndarray:
    """Apply a [0,1]-coordinate homography to [0,1] points."""
    ones = np.ones((poi01.shape[0], 1))
    ph = np.concatenate([poi01, ones], axis=1) @ np.asarray(theta).T
    return ph[:, :2] / ph[:, 2:3]


def _render_mask(field_mask: np.ndarray, theta01: np.ndarray,
                 mask_size) -> np.ndarray:
    """Warp the one-hot court template into the frame with cv2 (host-side,
    pixel-space homography derived from the [0,1]-space theta)."""
    import cv2

    th, tw = field_mask.shape[:2]
    # [0,1]->pixels on both sides: S_out @ theta01 @ S_template^-1
    theta_px = _pixel_theta(theta01, (tw, th), mask_size)
    return cv2.warpPerspective(field_mask, theta_px, tuple(mask_size),
                               flags=cv2.INTER_NEAREST)


def _pixel_theta(theta01: np.ndarray, template_size, out_size) -> np.ndarray:
    """[0,1]-coordinate homography -> pixel-space cv2 homography."""
    w, h = out_size
    tw, th = template_size
    s_out = np.array([[w, 0, 0], [0, h, 0], [0, 0, 1]], np.float64)
    s_t_inv = np.array([[1.0 / tw, 0, 0], [0, 1.0 / th, 0], [0, 0, 1]],
                       np.float64)
    return s_out @ np.asarray(theta01, np.float64) @ s_t_inv


def build_uv_masks(dst_dir: str, mask_size=(1280, 720), uv_offset=(8, 8),
                   anno_subdir="anno", mask_subdir="masks",
                   out_subdir="masks_uv"):
    """Notebook step 9: per-frame uint16 (mask, u, v) tiffs.

    Reads the ``anno/<game>/<frame>.json`` thetas and the one-hot
    ``masks/<game>/<frame>.png`` this script produced, warps the
    normalized (0,1] UV coordinate ramps (court/template space, border
    pixels zeroed by ``uv_offset`` like the notebook's ``x_offset=(8,8)``)
    into the frame with the SAME pixel homography as the segmentation
    mask render, scales to uint16 full range and stacks
    ``(mask, u, v)`` -> ``masks_uv/<game>/<frame>.tif``
    (cell 15 of ``football_dataset.ipynb``).
    """
    import cv2

    w, h = mask_size
    off = (int(uv_offset[0]), int(uv_offset[1]))
    u16, v16 = generate_uv_template((w, h), dtype=np.uint16,
                                    x_offset=off, y_offset=off)
    # the notebook normalizes the integer ramp by the size, keeping the
    # trimmed border pixels exactly 0 (background sentinel for flips)
    u_t = u16.astype(np.float64) / float(w)
    v_t = v16.astype(np.float64) / float(h)
    max16 = float(np.iinfo(np.uint16).max)

    anno_root = os.path.join(dst_dir, anno_subdir)
    counts = {}
    games = [g for g in sorted(os.listdir(anno_root))
             if os.path.isdir(os.path.join(anno_root, g))]
    for game in games:
        out_dir = os.path.join(dst_dir, out_subdir, game)
        os.makedirs(out_dir, exist_ok=True)
        done = 0
        for name in sorted(os.listdir(os.path.join(anno_root, game))):
            if not name.endswith(".json"):
                continue
            frame_id = name[:-len(".json")]
            with open(os.path.join(anno_root, game, name)) as f:
                theta01 = np.asarray(json.load(f)["theta"], np.float64)
            mask_path = os.path.join(dst_dir, mask_subdir, game,
                                     frame_id + ".png")
            mask = cv2.imread(mask_path, -1)
            if mask is None:
                continue
            if mask.ndim == 3:
                mask = mask[..., 0]
            theta_px = _pixel_theta(theta01, mask_size, mask_size)
            u = cv2.warpPerspective(u_t, theta_px, (w, h),
                                    flags=cv2.INTER_NEAREST)
            v = cv2.warpPerspective(v_t, theta_px, (w, h),
                                    flags=cv2.INTER_NEAREST)
            uv_mask = np.stack((mask.astype(np.uint16),
                                (u * max16).astype(np.uint16),
                                (v * max16).astype(np.uint16)), axis=2)
            cv2.imwrite(os.path.join(out_dir, frame_id + ".tif"), uv_mask)
            done += 1
        counts[game] = done
        print(f"{game}: {done} uv-masks written")
    return counts


def build_dataset(anno_dir: str, field_poi_path: str, dst_dir: str,
                  field_mask_path=None, mask_size=(1280, 720),
                  ignore_pts=None, norm_size=None):
    """Run the full preparation pipeline; returns per-game frame counts."""
    field_poi = load_court_poi(field_poi_path, normalize=False)   # [0,1]
    field_mask = None
    if field_mask_path is not None:
        field_mask = read_image(field_mask_path)
        if field_mask.ndim == 3:
            field_mask = field_mask[..., 0]

    requests = generate_requests(anno_dir)
    counts = {}
    for game, frames in requests.items():
        game_anno_dir = os.path.join(dst_dir, "anno", game)
        game_mask_dir = os.path.join(dst_dir, "masks", game)
        os.makedirs(game_anno_dir, exist_ok=True)
        if field_mask is not None:
            os.makedirs(game_mask_dir, exist_ok=True)
        done = 0
        for frame_id, req in frames.items():
            manual = np.asarray(req["manual_poi"], dtype=np.float64)
            theta = calculate_homography(field_poi, manual)
            if theta is None:
                continue
            proj = _project_poi(theta, field_poi)
            nonzero = find_nonzero_points(manual, ignore_pts)
            rmse = calculate_reprojection_rmse(proj, manual, nonzero,
                                               norm_size=norm_size)
            poi_out = np.concatenate(
                [np.where(nonzero[:, None], manual, proj),
                 nonzero[:, None].astype(np.float64)], axis=1)
            with open(os.path.join(game_anno_dir, f"{frame_id}.json"), "w") as f:
                json.dump({"poi": poi_out.tolist(),
                           "theta": np.asarray(theta).tolist(),
                           "reproj_mse": float(rmse)}, f)
            if field_mask is not None:
                _save_png(os.path.join(game_mask_dir, f"{frame_id}.png"),
                          _render_mask(field_mask, theta, mask_size))
            done += 1
        counts[game] = done
        print(f"{game}: {done} frames prepared")
    return counts


def main(argv=None):
    p = argparse.ArgumentParser(description="Dataset preparation")
    p.add_argument("--anno_dir", required=True)
    p.add_argument("--field_poi", required=True)
    p.add_argument("--field_mask", default=None)
    p.add_argument("--dst_dir", required=True)
    p.add_argument("--mask_size", nargs=2, type=int, default=(1280, 720))
    p.add_argument("--ignore_pts", type=str, default=None,
                   help="comma-separated PoI indices to exclude from RMSE")
    p.add_argument("--uv", action="store_true",
                   help="also write uint16 (mask,u,v) tiffs to masks_uv/ "
                        "(notebook step 9; requires --field_mask)")
    p.add_argument("--uv_offset", nargs=2, type=int, default=(8, 8),
                   help="UV template border trim (notebook x/y_offset)")
    args = p.parse_args(argv)
    ignore = ([int(x) for x in args.ignore_pts.split(",")]
              if args.ignore_pts else None)
    counts = build_dataset(args.anno_dir, args.field_poi, args.dst_dir,
                           args.field_mask, tuple(args.mask_size), ignore)
    if args.uv:
        assert args.field_mask is not None, "--uv requires --field_mask"
        build_uv_masks(args.dst_dir, tuple(args.mask_size),
                       tuple(args.uv_offset))
    return counts


if __name__ == "__main__":
    main()
