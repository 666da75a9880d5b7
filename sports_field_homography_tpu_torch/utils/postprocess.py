"""Host-side post-processing of the predict CLI's outputs (port of
``utils/postprocess.py``): logits to labels, the class palettes, the debug
overlay and its text.

numpy only, except ``draw_text``, which needs cv2 and imports it when
called: the mask outputs run where cv2 is not installed.
"""
from __future__ import annotations

import numpy as np

__all__ = ["preds_to_masks", "onehot_to_image", "overlay", "draw_text",
           "CLASS_PALETTES"]

# id -> BGR colour, per class count (the JAX package's palettes)
CLASS_PALETTES = {
    4: {1: (0, 255, 0), 2: (255, 0, 0), 3: (0, 0, 255)},
    7: {1: (0, 255, 0), 2: (255, 0, 0), 3: (0, 0, 255), 4: (255, 255, 255),
        5: (255, 0, 255), 6: (0, 255, 255)},
    8: {1: (0, 255, 0), 2: (255, 0, 0), 3: (0, 0, 255), 4: (255, 255, 255),
        5: (255, 0, 255), 6: (0, 255, 255), 7: (255, 255, 0)},
}


def preds_to_masks(preds, n_classes: int = 1, to_ndarray: bool = True):
    """(B, H, W, C) logits -> label masks: argmax over the classes, or the
    sigmoid of the one channel when ``n_classes`` is 1; uint8 when
    ``to_ndarray``."""
    preds = np.asarray(preds)
    if n_classes > 1:
        masks = np.argmax(preds, axis=-1)
    else:
        masks = 1.0 / (1.0 + np.exp(-preds[..., 0]))
    if to_ndarray:
        masks = masks.astype(np.uint8)
    return masks


def onehot_to_image(masks, n_classes: int = 4) -> np.ndarray:
    """(H, W) or (B, H, W) label masks -> (B, H, W, 3) uint8 BGR images
    through the class palette (label 0 and unlisted labels black)."""
    masks = np.asarray(masks)
    if masks.ndim == 2:
        masks = masks[None]
    if n_classes not in CLASS_PALETTES:
        raise NotImplementedError(f"no palette for {n_classes} classes")
    lut = np.zeros((256, 3), dtype=np.uint8)
    for cid, color in CLASS_PALETTES[n_classes].items():
        lut[cid] = color
    return lut[masks.astype(np.uint8)]


def overlay(frame: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """50/50 blend of a coloured mask over a frame; pixels where the mask
    is pure black keep the frame as it is."""
    frame = np.asarray(frame)
    mask = np.asarray(mask)
    background = np.all(mask == 0, axis=-1, keepdims=True)
    blended = 0.5 * frame.astype(np.float32) + 0.5 * mask.astype(np.float32)
    out = np.where(background, frame.astype(np.float32), blended)
    return np.ascontiguousarray(out.astype(np.uint8))


def draw_text(img, text, pos, color=(255, 255, 255), scale=0.75, lineType=1,
              font=None):
    """Draw ``text`` on ``img`` in place with cv2 (imported here)."""
    import cv2

    if font is None:
        font = cv2.FONT_HERSHEY_COMPLEX_SMALL
    cv2.putText(img, text, pos, font, scale, color, lineType)
