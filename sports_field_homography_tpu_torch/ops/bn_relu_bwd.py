"""K7-bwd: backward of ``out = relu(bn_train(y))`` (biased batch variance).

Port of ``ops/bn_pallas.py::_bwd_reduce_kernel`` and ``::_dx_kernel`` as
``ops/double_conv.py::_bn_relu_bwd`` composes them:

    xhat = (y - mean) * rstd,   dy' = g * [xhat * gamma + beta > 0]
    dbeta = sum(dy'),           dgamma = sum(dy' * xhat)
    dy_in = gamma * rstd * (dy' - dbeta / M - xhat * dgamma / M)

over the M = N*H*W pixels, per channel.  The ReLU mask is recomputed in
f32 from y, each operation rounded on its own in this order, so the CUDA
kernel (``csrc/bn_relu_bwd.cu``) and the plain version below agree on
every mask bit.  The kernel's per-block sums are added by
``ops/reduce.column_sums`` in a fixed order (no float atomics).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _dispatch
from .build import check, load_library
from .reduce import column_sums, rows_per_block

__all__ = ["bn_relu_bwd", "bn_relu_bwd_plain"]


def _check(y, g, mean):
    if y.dim() != 4 or g.shape != y.shape:
        raise ValueError(f"y and g must be one (N, H, W, C) shape, got "
                         f"{tuple(y.shape)} and {tuple(g.shape)}")
    if mean.shape != (y.shape[-1],):
        raise ValueError(f"per-channel vectors must be ({y.shape[-1]},), got "
                         f"{tuple(mean.shape)}")


def bn_relu_bwd_plain(y, g, mean, rstd, gamma, beta):
    _check(y, g, mean)
    m = y.shape[0] * y.shape[1] * y.shape[2]
    acc = _dispatch.acc_dtype(y.dtype)
    mean, rstd, gamma, beta = (t.to(acc) for t in (mean, rstd, gamma, beta))
    xhat = (y.to(acc) - mean) * rstd
    pre = xhat * gamma + beta
    dyp = torch.where(pre > 0, g.to(acc), torch.zeros((), dtype=acc, device=y.device))
    dbeta = dyp.sum(dim=(0, 1, 2))
    dgamma = (dyp * xhat).sum(dim=(0, 1, 2))
    c1 = gamma * rstd
    dy = c1 * (dyp - dbeta / m - xhat * (dgamma / m))
    return dy.to(y.dtype), dgamma, dbeta


def bn_relu_bwd(y: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                rstd: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of relu(bn_train(y)) for the output cotangent g.

    Args:
      y: (N, H, W, C) float32 or bfloat16, the BN input.
      g: (N, H, W, C) cotangent of the ReLU output (cast to y's dtype).
      mean, rstd: (C,) f32 batch mean and rsqrt(var + eps); gamma, beta:
        (C,) BN scale and shift.
    Returns:
      (dy in y's dtype, dgamma f32, dbeta f32).
    """
    if _dispatch.on_cpu(y, g, mean, rstd, gamma, beta):
        return bn_relu_bwd_plain(y, g, mean, rstd, gamma, beta)
    _check(y, g, mean)
    code_dt = _dispatch.dtype_code(y.dtype)
    n, h, w, c = y.shape
    m = n * h * w
    _dispatch.check_pixels(n, h, w)
    y = y.contiguous()
    g = g.to(y.dtype).contiguous()
    mean, rstd, gamma, beta = (t.float().contiguous()
                               for t in (mean, rstd, gamma, beta))
    dx = torch.empty_like(y)
    if m == 0:
        zeros = torch.zeros(c, dtype=torch.float32, device=y.device)
        return dx, zeros, zeros.clone()
    rpb = rows_per_block(m)
    part = torch.empty((-(-m // rpb), 2 * c), dtype=torch.float32, device=y.device)
    lib = load_library()
    stream = _dispatch.stream_handle(y.device)
    with torch.cuda.device(y.device):
        check(lib.sfh_bn_relu_bwd_reduce(
            y.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), part.data_ptr(), m, c, rpb,
            code_dt, stream), "bn_relu_bwd (reduce)")
        sums = column_sums(part)
        dbeta, dgamma = sums[:c], sums[c:]
        c1 = gamma * rstd
        m1 = dbeta / m
        m2 = dgamma / m
        check(lib.sfh_bn_relu_bwd_dx(
            y.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), c1.data_ptr(), m1.data_ptr(),
            m2.data_ptr(), dx.data_ptr(), m, c, code_dt, stream),
            "bn_relu_bwd (dx)")
    bn_relu_bwd.launches += 1
    return dx, dgamma, dbeta


bn_relu_bwd.launches = 0
