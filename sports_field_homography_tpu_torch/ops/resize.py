"""Resizes of ``ops/resize.py``: the bilinear UNet's 2x up-sampling
(``upsample2x_bilinear``: ``nn.Upsample(scale_factor=2, mode="bilinear",
align_corners=True)`` over NHWC) and the nearest resize of the predict
path's full-grid warp labels onto the logits grid (``resize_nearest``).

There is no Pallas kernel behind either: the JAX package gathers with XLA.
The up-sampling calls ``F.interpolate`` on an NCHW view of the NHWC tensor
(channels-last memory, so no copy either way).  The JAX version lerps in
the input dtype (bf16 in bf16); PyTorch accumulates in f32 on the card, so
the two agree exactly only in f32.  The nearest resize is two index
gathers, with the indices torch's ``mode="nearest"`` takes.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["upsample2x_bilinear", "resize_nearest", "nearest_index"]


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, 2H, 2W, C), bilinear with align_corners=True."""
    _, h, w, _ = x.shape
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(2 * h, 2 * w), mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1).contiguous()


def nearest_index(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """torch ``mode="nearest"`` source indices, ``floor(i * f32(in / out))``
    in float32 and clamped to ``n_in - 1`` (JAX ``ops/resize._nearest_indices``)."""
    i = torch.arange(n_out, dtype=torch.float32, device=device)
    idx = torch.floor(i * float(np.float32(n_in / n_out))).long()
    return idx.clamp_max(n_in - 1)


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest resize of axes 1 and 2 ((B, H, W[, C]) of any dtype) to
    ``out_hw`` = (H, W), on the tensor's device: JAX ``ops/resize.resize_nearest``."""
    ho, wo = int(out_hw[0]), int(out_hw[1])
    h, w = x.shape[1], x.shape[2]
    if h != ho:
        x = x.index_select(1, nearest_index(h, ho, x.device))
    if w != wo:
        x = x.index_select(2, nearest_index(w, wo, x.device))
    return x
