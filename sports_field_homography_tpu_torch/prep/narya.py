"""Narya dataset import converters (port of ``prep/narya.py``).

Converts the two public Narya soccer datasets (github.com/DonsetPG/narya)
into this framework's ``manual_anno.json`` + frames layout, matching the
reference's notebook converters
(``dataset_utils/football_dataset.ipynb``, cells "Convert
Narya-keypoints-dataset" and ``convert_narya_homography_dataset_to_our``):

  * **keypoints** datasets: Pascal-VOC style XML per frame; each object's
    ``keypoints/x1,y1`` pixel position becomes a [0,1] PoI at *our* index
    via the fixed Narya->our order map; unseen PoI are (-1, -1).
  * **homography** datasets: ``<name>_homo.npy`` field->frame homographies
    in Narya's centered coordinates; our PoI annotation is the field PoI
    pushed through the *inverse* homography (field -> frame), shifted by
    the +-0.5 centering.  Narya homographies are noisy, so a fake
    reprojection RMSE downweights these samples during training (5.0 px
    base, +2.0 for 1024x1024 sources, +5.0 for 180x360).

Frames are resized to ``frame_size`` (INTER_CUBIC) and re-encoded as
quality-95 JPEGs named 000001.jpeg, 000002.jpeg, ... like every other
dataset this framework's loaders consume.

Usage:
  python -m sports_field_homography_tpu_torch.prep.narya keypoints \
      --src_img_dir .../JPEGImages --src_anno_dir .../Annotations \
      --dst_dir out/narya-keypoints-train
  python -m sports_field_homography_tpu_torch.prep.narya homography \
      --src_img_dir .../train_img --src_homo_dir .../train_homo \
      --field_poi assets/template_pitch_points.json \
      --dst_dir out/narya-homography-train
"""
from __future__ import annotations

import argparse
import json
import os
import xml.etree.ElementTree as ET

import numpy as np

from ..geometry.court import load_court_poi

__all__ = [
    "NARYA_TO_OUR_POI",
    "NUM_FOOTBALL_POI",
    "convert_narya_keypoints",
    "convert_narya_homography",
]

# Narya keypoint id -> our football-pitch PoI index
# (reference football_dataset.ipynb MAP_POI_ORDER_NARYA_TO_OUR).
NARYA_TO_OUR_POI = {
    0: 0, 1: 1, 2: 8, 3: 2, 4: 6, 5: 3, 6: 7, 7: 4,
    8: 11, 9: 5, 10: 14, 11: 16, 12: 18, 13: 27, 14: 28,
    15: 21, 16: 29, 17: 25, 18: 30, 19: 26, 20: 31, 21: 24,
    22: 32, 23: 9, 24: 10, 25: 15, 26: 17, 27: 22, 28: 23,
}

NUM_FOOTBALL_POI = 33          # football-pitch template PoI count
_JPEG_QUALITY = 95


def _save_frame(src_img_path: str, dst_img_path: str, frame_size):
    """Resize (INTER_CUBIC, like the notebook) and re-encode one frame.

    Returns the source (W, H) so the homography converter can pick its
    fake-RMSE tier from the original resolution.
    """
    import cv2

    img = cv2.imread(src_img_path, cv2.IMREAD_COLOR)
    h, w = img.shape[:2]
    if (w, h) != tuple(frame_size):
        img = cv2.resize(img, tuple(frame_size), interpolation=cv2.INTER_CUBIC)
    cv2.imwrite(dst_img_path, img,
                [cv2.IMWRITE_JPEG_QUALITY, _JPEG_QUALITY])
    return w, h


def _write_anno(dst_anno_dir: str, labels: dict):
    os.makedirs(dst_anno_dir, exist_ok=True)
    with open(os.path.join(dst_anno_dir, "manual_anno.json"), "w") as f:
        json.dump(labels, f, indent=2)


def _parse_voc_keypoints(anno_path: str, num_poi: int):
    """One Narya XML -> [0,1]-normalized PoI list at our ordering."""
    root = ET.parse(anno_path).getroot()
    size = root.find("size")
    width = float(size.find("width").text)
    height = float(size.find("height").text)
    poi = [(-1.0, -1.0)] * num_poi
    for obj in root.findall("object"):
        kp = obj.find("keypoints")
        x = float(kp.find("x1").text) / width
        y = float(kp.find("y1").text) / height
        poi[NARYA_TO_OUR_POI[int(obj.find("name").text)]] = (x, y)
    return poi


def convert_narya_keypoints(src_img_dir: str, src_anno_dir: str,
                            dst_img_dir: str, dst_anno_dir: str,
                            frame_size=(1280, 720),
                            num_poi: int = NUM_FOOTBALL_POI) -> int:
    """Narya keypoints dataset (XML annos) -> our manual_anno layout."""
    os.makedirs(dst_img_dir, exist_ok=True)
    names = sorted(n[:-len(".xml")] for n in os.listdir(src_anno_dir)
                   if n.endswith(".xml"))
    labels = {}
    counter = 0
    for src_name in names:
        src_img = os.path.join(src_img_dir, src_name + ".jpg")
        src_anno = os.path.join(src_anno_dir, src_name + ".xml")
        if not (os.path.isfile(src_img) and os.path.isfile(src_anno)):
            print(f"Skipping {src_name}...")
            continue
        dst_name = str(counter + 1).zfill(6)
        labels[dst_name] = {
            "theta": None,
            "poi": _parse_voc_keypoints(src_anno, num_poi),
            "elapsed": 0,
        }
        _save_frame(src_img, os.path.join(dst_img_dir, dst_name + ".jpeg"),
                    frame_size)
        counter += 1
    _write_anno(dst_anno_dir, labels)
    return counter


def _fake_rmse(src_w: int, src_h: int) -> float:
    """Downweighting RMSE for Narya's noisy homographies; the tiers match
    the notebook (base 5, +2 for 1024x1024, +5 for 180x360 sources)."""
    rmse = 5.0
    if (src_w, src_h) == (1024, 1024):
        rmse += 2.0
    if (src_w, src_h) == (180, 360):
        rmse += 5.0
    return rmse


def _apply_homography(theta: np.ndarray, pts: np.ndarray) -> np.ndarray:
    ph = np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1) @ theta.T
    return ph[:, :2] / ph[:, 2:3]


def convert_narya_homography(src_img_dir: str, src_homo_dir: str,
                             dst_img_dir: str, dst_anno_dir: str,
                             field_poi_path: str,
                             frame_size=(1280, 720)) -> int:
    """Narya homography dataset (.npy field->frame) -> our layout.

    PoI = inverse homography applied to the field PoI in Narya's centered
    ([-0.5, 0.5]) coordinates, shifted back to [0, 1].  PoI outside the
    frame are kept (the loaders' visibility masks handle them), matching
    the notebook's final behavior.
    """
    field_poi = load_court_poi(field_poi_path, normalize=False) - 0.5
    os.makedirs(dst_img_dir, exist_ok=True)
    suffix = "_homo.npy"
    names = sorted(n[:-len(suffix)] for n in os.listdir(src_homo_dir)
                   if n.endswith(suffix))
    labels = {}
    counter = 0
    for src_name in names:
        src_img = os.path.join(src_img_dir, src_name + ".jpg")
        src_homo = os.path.join(src_homo_dir, src_name + suffix)
        if not (os.path.isfile(src_img) and os.path.isfile(src_homo)):
            print(f"Skipping {src_name}...")
            continue
        theta = np.load(src_homo)
        if theta.ndim > 2:
            theta = theta[0]
        poi = _apply_homography(np.linalg.inv(theta), field_poi) + 0.5
        dst_name = str(counter + 1).zfill(6)
        src_w, src_h = _save_frame(
            src_img, os.path.join(dst_img_dir, dst_name + ".jpeg"),
            frame_size)
        labels[dst_name] = {
            "theta": None,
            "poi": poi.tolist(),
            "elapsed": 0,
            "rmse": _fake_rmse(src_w, src_h),
        }
        counter += 1
    _write_anno(dst_anno_dir, labels)
    return counter


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)

    kp = sub.add_parser("keypoints", help="convert a Narya keypoints dataset")
    kp.add_argument("--src_img_dir", required=True)
    kp.add_argument("--src_anno_dir", required=True)
    hm = sub.add_parser("homography", help="convert a Narya homography dataset")
    hm.add_argument("--src_img_dir", required=True)
    hm.add_argument("--src_homo_dir", required=True)
    hm.add_argument("--field_poi", required=True,
                    help="football-pitch PoI JSON (template_pitch_points.json)")
    for p in (kp, hm):
        p.add_argument("--dst_dir", required=True,
                       help="output root (frames/ + manual_anno.json)")
        p.add_argument("--frame_size", nargs=2, type=int, default=(1280, 720))

    args = ap.parse_args(argv)
    dst_img = os.path.join(args.dst_dir, "frames")
    if args.mode == "keypoints":
        n = convert_narya_keypoints(args.src_img_dir, args.src_anno_dir,
                                    dst_img, args.dst_dir,
                                    frame_size=tuple(args.frame_size))
    else:
        n = convert_narya_homography(args.src_img_dir, args.src_homo_dir,
                                     dst_img, args.dst_dir, args.field_poi,
                                     frame_size=tuple(args.frame_size))
    print(f"All done! Total files: {n}")


if __name__ == "__main__":
    main()
