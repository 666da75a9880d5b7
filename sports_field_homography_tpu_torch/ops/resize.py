"""The bilinear UNet's 2x up-sampling (port of ``ops/resize.py::
upsample2x_bilinear``): ``nn.Upsample(scale_factor=2, mode="bilinear",
align_corners=True)`` over NHWC.

There is no Pallas kernel behind it: the JAX package lerps with XLA
gathers, the port calls ``F.interpolate`` on an NCHW view of the NHWC
tensor (channels-last memory, so no copy either way).  The JAX version
lerps in the input dtype (bf16 in bf16); PyTorch accumulates in f32 on the
card, so the two agree exactly only in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["upsample2x_bilinear"]


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, 2H, 2W, C), bilinear with align_corners=True."""
    _, h, w, _ = x.shape
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(2 * h, 2 * w), mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1).contiguous()
