"""Inference DoubleConv: (conv3x3 -> eval BN -> ReLU) x 2 over NHWC.

Port of ``ops/double_conv.py::double_conv_eval`` without the TPU's packed
(width-pair) branches.  Composed of K2 (``ops/conv3x3.py``): BN1 and its
ReLU ride conv2's prologue; BN2 and its ReLU are one elementwise pass.
Folded variables (``ops/fold_bn.py``: scale 1, mean 0, var + eps == 1)
give inv = 1 and mean = 0 exactly, so the same code serves both.

The 3-channel stem conv is not a K2 launch: it stays on cuDNN, as the JAX
package keeps it on XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .conv3x3 import conv3x3

__all__ = ["double_conv_eval", "bn_inv", "STEM_CHANNELS"]

STEM_CHANNELS = 3


def bn_inv(scale: torch.Tensor, var: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-channel eval-BN multiplier ``rsqrt(var + eps) * scale`` (f32)."""
    return torch.rsqrt(var.float() + eps) * scale.float()


def _stem_conv(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    y = F.conv2d(x.permute(0, 3, 1, 2), k.to(dt).permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1) + b.to(dt)


def double_conv_eval(x, k1, b1, g1, be1, rm1, rv1, k2, b2, g2, be2, rm2, rv2,
                     eps: float = 1e-5) -> torch.Tensor:
    """(conv3x3 -> eval BN(running stats) -> ReLU) x 2.

    Args:
      x: (N, H, W, Cin) float32 or bfloat16.
      k1, k2: (3, 3, Cin, Cmid) and (3, 3, Cmid, Cout) HWIO weights.
      b1, b2: conv biases; g*, be*, rm*, rv*: BN scale, bias, running mean
        and running variance.
    Returns:
      (N, H, W, Cout) in x's dtype.
    """
    dt = x.dtype
    inv1 = bn_inv(g1, rv1, eps)
    inv2 = bn_inv(g2, rv2, eps)
    if x.shape[-1] == STEM_CHANNELS:
        y1 = _stem_conv(x, k1, b1)
    else:
        y1 = conv3x3(x, k1, b1)
    y2 = conv3x3(y1, k2, b2, prologue=(rm1.float(), inv1, be1.float()))
    out = torch.relu((y2.float() - rm2.float()) * inv2 + be2.float())
    return out.to(dt)
