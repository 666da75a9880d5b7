"""DoubleConv, (conv3x3 -> BN -> ReLU) x 2 over NHWC, for inference and
for training.

``double_conv_eval`` ports ``ops/double_conv.py::double_conv_eval``: K2
(``ops/conv3x3.py``) twice; BN1 and its ReLU ride conv2's prologue, BN2
and its ReLU are one elementwise pass.  Folded variables
(``ops/fold_bn.py``: scale 1, mean 0, var + eps == 1) give inv = 1 and
mean = 0 exactly, so the same code serves both.

``double_conv_train`` ports ``ops/double_conv.py::double_conv_train`` and
its custom VJP as a ``torch.autograd.Function``:

  forward:  y1 = K2(x) + b1 with stats -> mean1, var1 (biased)
            y2 = K2(relu(bn1(y1))) + b2, BN1+ReLU in the prologue, with
            stats -> mean2, var2;  out = relu(bn2(y2))  (torch)
  backward: K7-bwd (BN2+ReLU) -> dy2, dgamma2, dbeta2
            K5 wgrad of conv2 on y1, BN1+ReLU recomputed in its prologue
            K2 dgrad of conv2 (dgrad_weights, no bias) -> dz1
            K7-bwd (BN1+ReLU) -> dy1, dgamma1, dbeta1
            K5 wgrad of conv1;  K2 dgrad of conv1 -> dx

The batch statistics are returned detached, for the caller's running-stat
update, as in the JAX package.  The TPU's packed (width-pair) io modes and
its VMEM / pixel-count gates are not carried over: every train DoubleConv
runs this Function.

The 3-channel stem conv is not a K2 launch: it stays on cuDNN in both
directions, as the JAX package keeps it on XLA (``_xla_conv_stats``, and
the conv VJP in ``_bwd_vjp``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .bn_relu_bwd import bn_relu_bwd
from .conv3x3 import conv3x3, dgrad_weights
from .wgrad3x3 import wgrad3x3

__all__ = ["double_conv_eval", "double_conv_train", "bn_inv", "STEM_CHANNELS"]

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


def _stem_conv_stats(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor):
    """The stem conv (cuDNN) in f32 on the x-dtype-valued inputs, plus the
    bias and the stat sums, then rounded to x's dtype (the JAX package's
    ``_xla_conv_stats``: f32 accumulation, sums before the rounding)."""
    dt = x.dtype
    y = F.conv2d(x.float().permute(0, 3, 1, 2),
                 k.to(dt).float().permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1) + b.float()
    sums = torch.stack([y.sum(dim=(0, 1, 2)), (y * y).sum(dim=(0, 1, 2))])
    return y.to(dt).contiguous(), sums


def _finalize_stats(sums: torch.Tensor, m: int, eps: float):
    """mean = sum / M, var = sumsq / M - mean^2 (biased), rstd, in f32."""
    mean = sums[0] / m
    var = sums[1] / m - mean * mean
    return mean, var, torch.rsqrt(var + eps)


class _DoubleConvTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, k1, b1, g1, be1, k2, b2, g2, be2, eps):
        dt = x.dtype
        n, h, w, cin = x.shape
        m = n * h * w
        if cin == STEM_CHANNELS:
            y1, s1 = _stem_conv_stats(x, k1, b1)
        else:
            y1, s1 = conv3x3(x, k1, b1, stats=True)
        mean1, var1, rstd1 = _finalize_stats(s1, m, eps)
        inv1 = rstd1 * g1.float()
        y2, s2 = conv3x3(y1, k2, b2, prologue=(mean1, inv1, be1.float()),
                         stats=True)
        mean2, var2, rstd2 = _finalize_stats(s2, m, eps)
        inv2 = rstd2 * g2.float()
        out = torch.relu((y2.float() - mean2) * inv2 + be2.float()).to(dt)
        ctx.save_for_backward(x, y1, y2, mean1, rstd1, mean2, rstd2,
                              k1, g1, be1, k2, g2, be2)
        ctx.mark_non_differentiable(mean1, var1, mean2, var2)
        return out, mean1, var1, mean2, var2

    @staticmethod
    def backward(ctx, g, *_stat_cotangents):
        (x, y1, y2, mean1, rstd1, mean2, rstd2,
         k1, g1, be1, k2, g2, be2) = ctx.saved_tensors
        dt = x.dtype
        dy2, dg2, dbe2 = bn_relu_bwd(y2, g, mean2, rstd2, g2, be2)
        inv1 = rstd1 * g1.float()
        dk2, db2 = wgrad3x3(y1, dy2, prologue=(mean1, inv1, be1.float()))
        dz1 = conv3x3(dy2, dgrad_weights(k2))
        dy1, dg1, dbe1 = bn_relu_bwd(y1, dz1, mean1, rstd1, g1, be1)
        dx = None
        if x.shape[-1] == STEM_CHANNELS:
            kd = k1.to(dt).permute(3, 2, 0, 1)
            xn, dyn = x.permute(0, 3, 1, 2), dy1.permute(0, 3, 1, 2)
            dk1 = torch.nn.grad.conv2d_weight(xn, kd.shape, dyn, padding=1)
            dk1 = dk1.permute(2, 3, 1, 0).float()
            db1 = dy1.float().sum(dim=(0, 1, 2))
            if ctx.needs_input_grad[0]:
                dx = torch.nn.grad.conv2d_input(xn.shape, kd, dyn, padding=1)
                dx = dx.permute(0, 2, 3, 1)
        else:
            dk1, db1 = wgrad3x3(x, dy1)
            if ctx.needs_input_grad[0]:
                dx = conv3x3(dy1, dgrad_weights(k1))
        return dx, dk1, db1, dg1, dbe1, dk2, db2, dg2, dbe2, None


def double_conv_train(x, k1, b1, g1, be1, k2, b2, g2, be2, eps: float = 1e-5):
    """(conv3x3 -> train-BN -> ReLU) x 2, differentiable.

    Args:
      x: (N, H, W, Cin) float32 or bfloat16.
      k1, k2: (3, 3, Cin, Mid) and (3, 3, Mid, Cout) HWIO weights (cast to
        x's dtype for the convs); b1, b2: conv biases; g1, be1, g2, be2:
        BN scales and shifts.
    Returns:
      (out (N, H, W, Cout) in x's dtype, mean1, var1, mean2, var2): the
      batch means and biased variances in f32, detached.
    """
    return _DoubleConvTrain.apply(x, k1, b1, g1, be1, k2, b2, g2, be2, eps)
