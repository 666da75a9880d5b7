"""K7-fwd: train-mode BatchNorm + ReLU forward over NHWC (port of
``ops/bn_pallas.py``: ``_stats_kernel``, ``_norm_relu_kernel`` and the
public ``bn_relu_train``).

* ``bn_relu_stats(x)``: the (2, C) f32 sums ``[sum(x), sum(x*x)]`` over
  N*H*W.  The kernel (``csrc/bn_relu_fwd.cu``) writes one partial row per
  run of pixels (``ops/reduce.rows_per_block``) and ``ops/reduce.
  column_sums`` adds them in a fixed order: no float atomics, bitwise
  repeatable.
* ``bn_relu_norm(x, mean, inv, beta)``: ``relu((x - mean) * inv + beta)``
  per channel, each operation rounded on its own in f32 and the result
  rounded once to x's dtype: in f32 the kernel equals the plain version
  bit for bit.
* ``bn_relu_train(x, gamma, beta, eps)``: stats, then the biased variance
  and norm; an autograd Function whose backward is K7-bwd
  (``ops/bn_relu_bwd.py``).  Mean and var are returned detached, as the
  JAX ``_bwd_vjp`` ignores their cotangents.

In the port's DoubleConv the norm is the BN2+ReLU pass (eval and train,
with the train statistics from K2's stats epilogue) and the stats are the
stem conv's batch statistics.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _dispatch
from .bn_relu_bwd import bn_relu_bwd
from .build import check, load_library
from .conv3x3 import apply_prologue
from .reduce import column_sums, rows_per_block

__all__ = ["bn_relu_stats", "bn_relu_stats_plain", "bn_relu_norm",
           "bn_relu_norm_plain", "bn_relu_train", "finalize_stats"]

_MAX_NORM_CHANNELS = 4096      # mean | inv | beta in 48 KB of shared memory


def _check(x, *vecs):
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    for v in vecs:
        if v.shape != (x.shape[-1],):
            raise ValueError(f"per-channel vectors must be ({x.shape[-1]},), got "
                             f"{tuple(v.shape)}")


def finalize_stats(sums: torch.Tensor, m: int, eps: float):
    """mean = sum / M, var = sumsq / M - mean^2 (biased), rstd =
    rsqrt(var + eps), in f32 (JAX ``_fwd_impl`` and ``_finalize_stats``)."""
    mean = sums[0] / m
    var = sums[1] / m - mean * mean
    return mean, var, torch.rsqrt(var + eps)


def bn_relu_stats_plain(x: torch.Tensor) -> torch.Tensor:
    _check(x)
    xf = x.to(_dispatch.acc_dtype(x.dtype))
    return torch.stack([xf.sum(dim=(0, 1, 2)), (xf * xf).sum(dim=(0, 1, 2))])


def bn_relu_stats(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) float32 or bfloat16 -> (2, C) f32 [sum(x), sum(x*x)]."""
    if _dispatch.on_cpu(x):
        return bn_relu_stats_plain(x)
    _check(x)
    code_dt = _dispatch.dtype_code(x.dtype)
    n, h, w, c = x.shape
    m = n * h * w
    _dispatch.check_pixels(n, h, w)
    if m == 0:
        return torch.zeros((2, c), dtype=torch.float32, device=x.device)
    x = x.contiguous()
    rpb = rows_per_block(m)
    part = torch.empty((-(-m // rpb), 2 * c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        check(load_library().sfh_bn_relu_stats(
            x.data_ptr(), part.data_ptr(), m, c, rpb, code_dt,
            _dispatch.stream_handle(x.device)), "bn_relu_stats")
        sums = column_sums(part)
    bn_relu_stats.launches += 1
    return sums.view(2, c)


def bn_relu_norm_plain(x, mean, inv, beta):
    _check(x, mean, inv, beta)
    return apply_prologue(x, (mean, inv, beta))


def bn_relu_norm(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
                 beta: torch.Tensor) -> torch.Tensor:
    """relu((x - mean) * inv + beta) per channel (last axis), in f32,
    rounded once to x's dtype.

    Args:
      x: (N, H, W, C) float32 or bfloat16.
      mean, inv, beta: (C,) vectors (used in f32); inv = gamma * rstd for a
        train BN, gamma * rsqrt(running_var + eps) for an eval one.
    """
    if _dispatch.on_cpu(x, mean, inv, beta):
        return bn_relu_norm_plain(x, mean, inv, beta)
    _check(x, mean, inv, beta)
    code_dt = _dispatch.dtype_code(x.dtype)
    n, h, w, c = x.shape
    _dispatch.check_pixels(n, h, w)
    if c > _MAX_NORM_CHANNELS:
        raise ValueError(f"bn_relu_norm takes at most {_MAX_NORM_CHANNELS} channels, got {c}")
    x = x.contiguous()
    mean, inv, beta = (t.float().contiguous() for t in (mean, inv, beta))
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        check(load_library().sfh_bn_relu_norm(
            x.data_ptr(), mean.data_ptr(), inv.data_ptr(), beta.data_ptr(),
            y.data_ptr(), n * h * w, c, code_dt, _dispatch.stream_handle(x.device)),
            "bn_relu_norm")
    bn_relu_norm.launches += 1
    return y


bn_relu_stats.launches = 0
bn_relu_norm.launches = 0


class _BnReluTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        m = x.shape[0] * x.shape[1] * x.shape[2]
        mean, var, rstd = finalize_stats(bn_relu_stats(x), m, eps)
        y = bn_relu_norm(x, mean, rstd * gamma.float(), beta.float())
        ctx.save_for_backward(x, gamma, beta, mean, rstd)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, *_stat_cotangents):
        x, gamma, beta, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = bn_relu_bwd(x, g, mean, rstd, gamma, beta)
        return dx, dgamma, dbeta, None


def bn_relu_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """relu(batchnorm_train(x)) with the batch statistics, differentiable
    in x, gamma and beta.

    Args:
      x: (N, H, W, C) float32 or bfloat16.
      gamma, beta: (C,) scale and shift.
    Returns:
      (y in x's dtype, mean, var): the batch mean and biased variance in
      f32, detached (the caller applies the unbiased factor for the running
      stats).
    """
    return _BnReluTrain.apply(x, gamma, beta, eps)
