"""DoubleConv, (conv3x3 -> BN -> ReLU) x 2 over NHWC, for inference and
for training.

``double_conv_eval`` ports ``ops/double_conv.py::double_conv_eval``: K2
(``ops/conv3x3.py``) twice; BN1 and its ReLU ride conv2's prologue, BN2
and its ReLU are K7-fwd's norm (``ops/bn_relu.py``).  Folded variables
(``ops/fold_bn.py``: scale 1, mean 0, var + eps == 1) give inv = 1 and
mean = 0 exactly, so the same code serves both.

``double_conv_train`` ports ``ops/double_conv.py::double_conv_train`` and
its custom VJP as a ``torch.autograd.Function``:

  forward:  y1 = K2(x) + b1 with stats -> mean1, var1 (biased)
            y2 = K2(relu(bn1(y1))) + b2, BN1+ReLU in the prologue, with
            stats -> mean2, var2;  out = K7-fwd norm (relu(bn2(y2)))
  backward: K7-bwd (BN2+ReLU) -> dy2, dgamma2, dbeta2
            K5 wgrad of conv2 on y1, BN1+ReLU recomputed in its prologue
            K2 dgrad of conv2 (dgrad_weights, no bias) -> dz1
            K7-bwd (BN1+ReLU) -> dy1, dgamma1, dbeta1
            K5 wgrad of conv1;  K2 dgrad of conv1 -> dx

The batch statistics are returned detached, for the caller's running-stat
update, as in the JAX package.  The TPU's packed (width-pair) io modes and
its VMEM / pixel-count gates are not carried over: every train DoubleConv
runs this Function.

Decoder DoubleConvs take a second input (``x2``, the up-sampled tensor;
``x`` is the skip): conv1 is K2's two-input form over the channel concat
``[x, x2]`` without building it (JAX ``dual_packed`` io), ``k1`` split
along its input axis at x's channel count.  Its backward, as JAX
``_conv1_bwd`` does for that io: K5 wgrad of dy1 against each input,
concatenated along the input axis; db1 once; K2 dgrad with each half's
``dgrad_weights``, giving the two input gradients.  The Function saves the
two inputs, not a concat.

Data parallel (``sync``, a ``parallel/distributed.Replicas``): BatchNorm
over the global batch, as the JAX package's ``bn_axis_name`` does (its
sync path stays on XLA; here the kernels stay on it).  The (2, C) sums of
K2's stats epilogue (the stem's: K7-fwd's stats) are all-reduced before
``finalize_stats``, with the global count M, so unequal shards are exact;
each K7-bwd call splits around the all-reduce of its 2C sums
(``bn_relu_bwd_sums``, then ``bn_relu_bwd_dx`` with the global M).  The
dgamma / dbeta this Function returns are the rank's own sums, taken before
that all-reduce: the gradient all-reduce adds them once, as every other
parameter's share.

The 3-channel stem conv is not a K2 launch: it stays on cuDNN in both
directions, as the JAX package keeps it on XLA (``_xla_conv_stats``, and
the conv VJP in ``_bwd_vjp``); its batch statistics are K7-fwd's stats of
the f32 conv output, taken before the rounding to x's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .bn_relu import bn_relu_norm, bn_relu_stats, finalize_stats
from .bn_relu_bwd import bn_relu_bwd, bn_relu_bwd_dx, bn_relu_bwd_sums
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


def _is_stem(x, x2) -> bool:
    return x2 is None and x.shape[-1] == STEM_CHANNELS


def _conv1(x, x2, k1, b1, stats: bool = False):
    """conv1 on K2: one input, or the two-input form over [x, x2] with k1
    split along its input axis at x's channel count."""
    if x2 is None:
        return conv3x3(x, k1, b1, stats=stats)
    ca = x.shape[-1]
    return conv3x3(x, k1[:, :, :ca], b1, stats=stats, x2=x2, w2=k1[:, :, ca:])


def double_conv_eval(x, k1, b1, g1, be1, rm1, rv1, k2, b2, g2, be2, rm2, rv2,
                     eps: float = 1e-5, x2=None) -> torch.Tensor:
    """(conv3x3 -> eval BN(running stats) -> ReLU) x 2.

    Args:
      x: (N, H, W, Cin) float32 or bfloat16 (the skip, with ``x2``).
      k1, k2: (3, 3, Cin [+ Cin2], Cmid) and (3, 3, Cmid, Cout) HWIO weights.
      b1, b2: conv biases; g*, be*, rm*, rv*: BN scale, bias, running mean
        and running variance.
      x2: optional (N, H, W, Cin2) second input in x's dtype (the decoder's
        up-sampled tensor): conv1 runs on the concat [x, x2] without it.
    Returns:
      (N, H, W, Cout) in x's dtype.
    """
    inv1 = bn_inv(g1, rv1, eps)
    inv2 = bn_inv(g2, rv2, eps)
    if _is_stem(x, x2):
        y1 = _stem_conv(x, k1, b1)
    else:
        y1 = _conv1(x, x2, k1, b1)
    y2 = conv3x3(y1, k2, b2, prologue=(rm1.float(), inv1, be1.float()))
    return bn_relu_norm(y2, rm2.float(), inv2, be2.float())


def _stem_conv_stats(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor):
    """The stem conv (cuDNN) in f32 on the x-dtype-valued inputs, plus the
    bias, then K7-fwd's stat sums of that f32 result, then the rounding to
    x's dtype (the JAX package's ``_xla_conv_stats``: f32 accumulation,
    sums before the rounding)."""
    dt = x.dtype
    y = F.conv2d(x.float().permute(0, 3, 1, 2),
                 k.to(dt).float().permute(3, 2, 0, 1), padding=1)
    y = (y.permute(0, 2, 3, 1) + b.float()).contiguous()
    return y.to(dt), bn_relu_stats(y)


def _bn_relu_bwd(ctx, y, g, mean, rstd, gamma, beta):
    """K7-bwd in one call, or, with ``ctx.sync``, split around the
    all-reduce of its sums; returns (dy, this rank's dgamma, dbeta)."""
    if ctx.sync is None:
        return bn_relu_bwd(y, g, mean, rstd, gamma, beta)
    c = y.shape[-1]
    sums = bn_relu_bwd_sums(y, g, mean, rstd, gamma, beta)
    own = sums.clone()
    ctx.sync.all_reduce_(sums)
    return bn_relu_bwd_dx(y, g, mean, rstd, gamma, beta, sums, ctx.m), own[c:], own[:c]


class _DoubleConvTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, x2, k1, b1, g1, be1, k2, b2, g2, be2, eps, sync):
        n, h, w, _ = x.shape
        m = n * h * w if sync is None else sync.count(n * h * w)
        if _is_stem(x, x2):
            y1, s1 = _stem_conv_stats(x, k1, b1)
        else:
            y1, s1 = _conv1(x, x2, k1, b1, stats=True)
        if sync is not None:
            s1 = sync.all_reduce_(s1.contiguous())
        mean1, var1, rstd1 = finalize_stats(s1, m, eps)
        inv1 = rstd1 * g1.float()
        y2, s2 = conv3x3(y1, k2, b2, prologue=(mean1, inv1, be1.float()),
                         stats=True)
        if sync is not None:
            s2 = sync.all_reduce_(s2.contiguous())
        mean2, var2, rstd2 = finalize_stats(s2, m, eps)
        out = bn_relu_norm(y2, mean2, rstd2 * g2.float(), be2.float())
        ctx.save_for_backward(x, x2, y1, y2, mean1, rstd1, mean2, rstd2,
                              k1, g1, be1, k2, g2, be2)
        ctx.mark_non_differentiable(mean1, var1, mean2, var2)
        ctx.sync, ctx.m = sync, m
        return out, mean1, var1, mean2, var2

    @staticmethod
    def backward(ctx, g, *_stat_cotangents):
        (x, x2, y1, y2, mean1, rstd1, mean2, rstd2,
         k1, g1, be1, k2, g2, be2) = ctx.saved_tensors
        dt = x.dtype
        dy2, dg2, dbe2 = _bn_relu_bwd(ctx, y2, g, mean2, rstd2, g2, be2)
        inv1 = rstd1 * g1.float()
        dk2, db2 = wgrad3x3(y1, dy2, prologue=(mean1, inv1, be1.float()))
        dz1 = conv3x3(dy2, dgrad_weights(k2))
        dy1, dg1, dbe1 = _bn_relu_bwd(ctx, y1, dz1, mean1, rstd1, g1, be1)
        dx = dx2 = None
        if _is_stem(x, x2):
            kd = k1.to(dt).permute(3, 2, 0, 1)
            xn, dyn = x.permute(0, 3, 1, 2), dy1.permute(0, 3, 1, 2)
            dk1 = torch.nn.grad.conv2d_weight(xn, kd.shape, dyn, padding=1)
            dk1 = dk1.permute(2, 3, 1, 0).float()
            db1 = dy1.float().sum(dim=(0, 1, 2))
            if ctx.needs_input_grad[0]:
                dx = torch.nn.grad.conv2d_input(xn.shape, kd, dyn, padding=1)
                dx = dx.permute(0, 2, 3, 1)
        elif x2 is None:
            dk1, db1 = wgrad3x3(x, dy1)
            if ctx.needs_input_grad[0]:
                dx = conv3x3(dy1, dgrad_weights(k1))
        else:
            ca = x.shape[-1]
            k1a, k1b = k1[:, :, :ca], k1[:, :, ca:]
            dka, db1 = wgrad3x3(x, dy1)
            dkb, _ = wgrad3x3(x2, dy1)
            dk1 = torch.cat([dka, dkb], dim=2)
            if ctx.needs_input_grad[0]:
                dx = conv3x3(dy1, dgrad_weights(k1a))
            if ctx.needs_input_grad[1]:
                dx2 = conv3x3(dy1, dgrad_weights(k1b))
        return dx, dx2, dk1, db1, dg1, dbe1, dk2, db2, dg2, dbe2, None, None


def double_conv_train(x, k1, b1, g1, be1, k2, b2, g2, be2, eps: float = 1e-5,
                      x2=None, sync=None):
    """(conv3x3 -> train-BN -> ReLU) x 2, differentiable.

    Args:
      x: (N, H, W, Cin) float32 or bfloat16 (the skip, with ``x2``).
      k1, k2: (3, 3, Cin [+ Cin2], Mid) and (3, 3, Mid, Cout) HWIO weights
        (cast to x's dtype for the convs); b1, b2: conv biases; g1, be1,
        g2, be2: BN scales and shifts.
      x2: optional (N, H, W, Cin2) second input in x's dtype: conv1 runs
        on the concat [x, x2] without building it.
      sync: a ``parallel/distributed.Replicas`` whose ``set_batch`` has
        run for this batch: BatchNorm over every rank's batch.
    Returns:
      (out (N, H, W, Cout) in x's dtype, mean1, var1, mean2, var2): the
      batch means and biased variances in f32 (of the global batch with
      ``sync``), detached.
    """
    return _DoubleConvTrain.apply(x, x2, k1, b1, g1, be1, k2, b2, g2, be2, eps, sync)
