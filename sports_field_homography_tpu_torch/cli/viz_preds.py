"""Prediction-video renderer (port of ``cli/viz_preds.py``).  Run it with::

    python -m sports_field_homography_tpu_torch.cli.viz_preds \\
        --video_path game/clip.mp4 --preds_path out/game_court.json \\
        --masks_path out/court/segm_mask/data.pkl --dst_dir viz/ [--no_encode]

It reads a ``{game}_court.json`` of the predict CLI, its pickled segm-mask
stream and the source video.  Per frame, a score below the threshold
draws the court template warped by the frame's theta (green score), any
other the decoded segmentation mask (red score); the overlay goes to PNG
chunks of 10,000 frames, which ffmpeg encodes to ``output.mp4`` unless
``--no_encode`` keeps the PNGs.  The warp is K1 (``ops/warp.warp_nearest``)
on ``--device`` (the card by default; ``cpu`` runs its plain version).
Video decode, PNG writes and the text need cv2; the encode needs an
``ffmpeg`` binary, and without one the renderer refuses to start unless
``--no_encode`` is given.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import pickle
import shutil
from subprocess import PIPE, run

import numpy as np
import torch

from ..data.assets import open_court_template
from ..ops.warp import warp_nearest
from ..utils.config import resolve_asset
from ..utils.postprocess import draw_text, onehot_to_image, overlay

__all__ = ["vizualize", "main", "get_args", "PredictionReader", "VideoReader",
           "MaskReader", "quotient_table"]


def quotient_table(num_classes: int) -> torch.Tensor:
    """(256,) float32 ``label / num_classes``, each quotient rounded once to
    float32: the value the JAX renderer's float template holds for each
    label (its plain nearest warp, not the interval table of
    ``ops/warp.template_value_table``, whose values for 7 classes lie an
    ulp or two below the quotients and truncate to the label below)."""
    return torch.arange(256, dtype=torch.float32) / float(num_classes)


class PredictionReader:
    """Per-frame entries of a ``{game}_court.json`` (the artifact format
    defined by reference ``predict.py:399-407``), minus the ``model``
    metadata key.  Iterates ``(frame_name, pred_dict)``."""

    def __init__(self, path):
        with open(path, "r") as f:
            data = json.load(f)
        data.pop("model", None)
        self.frames = list(data.items())

    def __len__(self):
        return len(self.frames)

    def __iter__(self):
        return iter(self.frames)


class VideoReader:
    """Sequential ``(frame_number, bgr_frame)`` iterator over an mp4."""

    def __init__(self, path):
        import cv2

        self._cv2 = cv2
        self.cap = cv2.VideoCapture(path)

    def __len__(self):
        if self.cap is None:
            return 0
        return int(self.cap.get(self._cv2.CAP_PROP_FRAME_COUNT))

    def __iter__(self):
        assert self.cap.isOpened()
        try:
            for f_num in itertools.count():
                ok, frame = self.cap.read()
                if not ok:
                    break
                yield f_num, frame
        finally:
            # GeneratorExit-safe: zip() stopping early (preds/masks shorter
            # than the video) must still release the capture promptly
            self.cap.release()


def _iter_pickle_stream(path):
    """Records of the concatenated-pickle mask stream the predict CLIs
    write (``[frame_name, png_buffer]``, reference ``predict.py:26-37``)."""
    with open(path, "rb") as f:
        while True:
            try:
                yield pickle.load(f)
            except EOFError:
                return


class MaskReader:
    """Iterates ``(frame_name, png_buffer)`` from a pickled mask stream;
    without one, yields ``(frame_name, None)`` per prediction so the
    render loop's three-way zip stays aligned."""

    def __init__(self, path=None, names=None):
        assert (path is None) != (names is None)
        self.entries = (list(_iter_pickle_stream(path)) if path is not None
                        else [(n, None) for n in names])

    def __len__(self):
        return len(self.entries)

    def __iter__(self):
        return iter(self.entries)

    @staticmethod
    def decode(buf):
        import cv2

        return cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)


def vizualize(video_path, preds_path, dst_dir, field_path, masks_path=None,
              mask_classes=4, out_size=(1280, 720), fps=30,
              score_threshold=0.1, overlay_threshold=None,
              encode_video=True, device="cuda"):
    """Render the predictions over the video.  ``encode_video=False`` keeps
    the rendered PNG chunks and skips the ffmpeg encode and concat.
    ``device`` runs the warp: K1 on a CUDA device, its plain version on the
    CPU.  Returns the number of frames that took the warp."""
    import cv2

    if encode_video and shutil.which("ffmpeg") is None:
        raise RuntimeError(
            "ffmpeg not found on PATH — rerun with --no_encode to keep the "
            "rendered PNG chunks instead of encoding an mp4")

    chunk_size = 10000
    out_w, out_h = out_size
    device = torch.device(device)

    preds = PredictionReader(preds_path)
    video = VideoReader(video_path)
    masks = MaskReader(masks_path) if masks_path is not None \
        else MaskReader(names=[name for name, _ in preds])

    court_labels = torch.from_numpy(
        open_court_template(resolve_asset(field_path), mask_classes, (out_w, out_h))).to(device)
    values = quotient_table(mask_classes).to(device)

    def warp_one(theta):
        """K1 at out_size; labels as the JAX renderer truncates them: the
        float32 product of the warped value and the class count."""
        out = warp_nearest(court_labels, theta, (out_h, out_w), values)
        return (out * mask_classes).to(torch.int32)

    temp_dir = os.path.join(dst_dir, "_temp")
    if os.path.exists(temp_dir):
        shutil.rmtree(temp_dir)
    os.makedirs(temp_dir)
    chunk_list_path = os.path.join(temp_dir, "chunks.txt")
    chunk_list_file = open(chunk_list_path, "w")
    chunk_i, counter, warped = 0, 0, 0
    dst_subdir = None

    def encode_chunk():
        nonlocal chunk_i, counter
        if not encode_video:
            chunk_i += 1
            counter = 0
            return
        dst_path = os.path.join(temp_dir, "chunk{}.mp4".format(chunk_i))
        chunk_list_file.write("file " + dst_path + "\n")
        cmd = ("ffmpeg -pattern_type glob -framerate {} -f image2 -i '{}*.png' {}"
               .format(fps, dst_subdir, dst_path))
        proc = run(cmd, stdout=PIPE, stderr=PIPE, universal_newlines=True,
                   shell=True)
        if proc.returncode != 0:
            raise RuntimeError("ffmpeg chunk encode failed:\n"
                               + proc.stderr[-2000:])
        shutil.rmtree(dst_subdir)
        chunk_i += 1
        counter = 0

    for (f_num, frame), (p_name, pred), (m_name, segm_mask) in zip(
            video, preds, masks):
        assert p_name == m_name and int(p_name) == f_num

        if counter == 0:
            dst_subdir = os.path.join(temp_dir, "_chunk{}/".format(chunk_i))
            os.makedirs(dst_subdir, exist_ok=True)

        score = pred["score"]
        theta = torch.tensor(pred["theta"], dtype=torch.float32).reshape(1, 3, 3)
        if score < score_threshold:
            mask = warp_one(theta.to(device))[0].cpu().numpy().astype(np.uint8)
            warped += 1
            color = (0, 255, 0)
        else:
            color = (0, 0, 255)
            mask = MaskReader.decode(segm_mask) if segm_mask is not None else None

        if mask is not None:
            mask = onehot_to_image(mask, mask_classes)[0]
            # resized to the frame's own size (the JAX renderer's rule)
            fh, fw = frame.shape[:2]
            if mask.shape[0] != fh or mask.shape[1] != fw:
                mask = cv2.resize(mask, (fw, fh),
                                  interpolation=cv2.INTER_NEAREST)

        if mask is not None and overlay_threshold is None or \
                (overlay_threshold is not None and score < overlay_threshold):
            frame = overlay(frame, mask)
        draw_text(frame, text="{:4f}".format(score), pos=(15, 15),
                  color=color, scale=0.75)

        cv2.imwrite(os.path.join(dst_subdir, p_name + ".png"), frame)
        counter += 1
        if counter >= chunk_size:
            encode_chunk()

    if counter != 0:
        encode_chunk()
    chunk_list_file.close()

    if not encode_video:
        print("Rendered frames kept in", temp_dir)
        print("All done!")
        return warped

    dst_video_path = os.path.join(dst_dir, "output.mp4")
    if os.path.exists(dst_video_path):
        os.remove(dst_video_path)
    cmd = "ffmpeg -f concat -safe 0 -i {} -c copy {}".format(
        chunk_list_path, dst_video_path)
    proc = run(cmd, stdout=PIPE, stderr=PIPE, universal_newlines=True,
               shell=True)
    if proc.returncode != 0 or not os.path.exists(dst_video_path):
        raise RuntimeError("ffmpeg concat failed:\n" + proc.stderr[-2000:])
    shutil.rmtree(temp_dir)
    print("Output video has been saved to", dst_video_path)
    print("All done!")
    return warped


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="Reconstructor viz")
    parser.add_argument("--video_path", type=str, default=None)
    parser.add_argument("--preds_path", type=str, default=None)
    parser.add_argument("--dst_dir", type=str, default=None)
    parser.add_argument("--masks_path", type=str, default=None)
    parser.add_argument("--field_path", type=str,
                        default="./assets/mask_ncaa_v4_nc4_m_onehot.png")
    parser.add_argument("--fps", type=int, default=30)
    parser.add_argument("--score_threshold", type=float, default=0.17)
    parser.add_argument("--overlay_threshold", type=float, default=None)
    parser.add_argument("--no_encode", action="store_true",
                        help="keep rendered PNG chunks, skip the ffmpeg "
                             "encode/concat")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the warp runs: cuda (K1) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    return vizualize(args.video_path, args.preds_path, args.dst_dir, args.field_path,
                     args.masks_path, fps=args.fps,
                     score_threshold=args.score_threshold,
                     overlay_threshold=args.overlay_threshold,
                     encode_video=not args.no_encode, device=args.device)


if __name__ == "__main__":
    main()
