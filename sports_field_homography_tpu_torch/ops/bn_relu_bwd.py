"""K7-bwd: backward of ``out = relu(bn_train(y))`` (biased batch variance).

Port of ``ops/bn_pallas.py::_bwd_reduce_kernel`` and ``::_dx_kernel`` as
``ops/double_conv.py::_bn_relu_bwd`` composes them:

    xhat = (y - mean) * rstd,   dy' = g * [xhat * gamma + beta > 0]
    dbeta = sum(dy'),           dgamma = sum(dy' * xhat)
    dy_in = gamma * rstd * (dy' - dbeta / M - xhat * dgamma / M)

over the M = N*H*W pixels, per channel.  The ReLU mask is recomputed in
f32 from y, each operation rounded on its own in this order, so the CUDA
kernels (``csrc/bn_relu_bwd.cu``) and the plain version below agree on
every mask bit.  One call makes three launches: the sums pass, a fixed-
order sum of its per-block partials (no float atomics: bitwise
repeatable), and the dx pass.  Both passes walk contiguous row chunks
(``row_schedule``) with one thread per channel group: 16 bytes a row on
the vector route (``vector_route``), one channel on the scalar route.

Data parallel (BatchNorm synced across ranks), the call splits around the
all-reduce of the 2C sums: ``bn_relu_bwd_sums`` (pass 1 and the finish,
this rank's rows) and ``bn_relu_bwd_dx`` (pass 2 with the all-reduced sums
and the global count M).  The same kernels, two entries; the one-call
``bn_relu_bwd`` stays the one-rank path.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _dispatch
from .build import check, load_library

__all__ = ["bn_relu_bwd", "bn_relu_bwd_plain", "bn_relu_bwd_sums",
           "bn_relu_bwd_sums_plain", "bn_relu_bwd_dx", "bn_relu_bwd_dx_plain",
           "vector_route", "row_lanes", "row_schedule"]

_THREADS = 256                 # threads a block (kThreads in the source)
_TARGET_BLOCKS = 132 * 4       # blocks a pass: four per SM of an H100
_MAX_RUN = 4096                # rows one thread sums in sequence, at most
_ITEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


def vector_route(dtype: torch.dtype, c: int, *ptrs: int) -> bool:
    """True where a thread moves 16 bytes a row: C a multiple of the values
    16 bytes hold (8 bf16, 4 f32) and every pointer (y, g, dx) 16-byte
    aligned."""
    return c % (16 // _ITEM_BYTES[dtype]) == 0 and all(p % 16 == 0 for p in ptrs)


def row_lanes(c: int, width: int) -> int:
    """Row lanes of a block: 256 threads over min(C / width, 256) channel
    groups of ``width`` channels (8 or 4 on the vector route, 1 on the
    scalar one)."""
    return _THREADS // min(c // width, _THREADS)


def row_schedule(m: int, lanes: int, target_blocks: int = _TARGET_BLOCKS):
    """(chunk, blocks): each block walks ``chunk`` contiguous rows (the last
    block what is left), its ``lanes`` row lanes taking every lanes-th row
    in order.  About ``target_blocks`` blocks fill the card; a chunk is a
    whole number of lane sweeps, and no lane sums more than _MAX_RUN rows in
    sequence (an f32 running sum over n terms drifts like sqrt(n) ulps)."""
    chunk = -(-m // target_blocks)
    chunk = min(-(-chunk // lanes) * lanes, _MAX_RUN * lanes)
    return chunk, -(-m // chunk)


def _check(y, g, mean):
    if y.dim() != 4 or g.shape != y.shape:
        raise ValueError(f"y and g must be one (N, H, W, C) shape, got "
                         f"{tuple(y.shape)} and {tuple(g.shape)}")
    if mean.shape != (y.shape[-1],):
        raise ValueError(f"per-channel vectors must be ({y.shape[-1]},), got "
                         f"{tuple(mean.shape)}")


def _relu_grad(y, g, mean, rstd, gamma, beta):
    """(xhat, dy') in the accumulation dtype: the plain versions' shared
    first steps, each rounded on its own in the kernels' order."""
    acc = _dispatch.acc_dtype(y.dtype)
    mean, rstd, gamma, beta = (t.to(acc) for t in (mean, rstd, gamma, beta))
    xhat = (y.to(acc) - mean) * rstd
    pre = xhat * gamma + beta
    dyp = torch.where(pre > 0, g.to(acc), torch.zeros((), dtype=acc, device=y.device))
    return xhat, dyp


def bn_relu_bwd_sums_plain(y, g, mean, rstd, gamma, beta):
    _check(y, g, mean)
    xhat, dyp = _relu_grad(y, g, mean, rstd, gamma, beta)
    return torch.cat([dyp.sum(dim=(0, 1, 2)), (dyp * xhat).sum(dim=(0, 1, 2))])


def bn_relu_bwd_dx_plain(y, g, mean, rstd, gamma, beta, sums, m_total):
    _check(y, g, mean)
    c = y.shape[-1]
    xhat, dyp = _relu_grad(y, g, mean, rstd, gamma, beta)
    acc = xhat.dtype
    dbeta, dgamma = sums[:c].to(acc), sums[c:].to(acc)
    c1 = gamma.to(acc) * rstd.to(acc)
    dy = c1 * (dyp - dbeta / m_total - xhat * (dgamma / m_total))
    return dy.to(y.dtype)


def bn_relu_bwd_plain(y, g, mean, rstd, gamma, beta):
    m = y.shape[0] * y.shape[1] * y.shape[2]
    sums = bn_relu_bwd_sums_plain(y, g, mean, rstd, gamma, beta)
    c = y.shape[-1]
    dx = bn_relu_bwd_dx_plain(y, g, mean, rstd, gamma, beta, sums, m)
    return dx, sums[c:], sums[:c]


def _prepare(y, g, mean, rstd, gamma, beta):
    """The kernels' operands: y and g contiguous in one dtype, the vectors
    contiguous f32."""
    _check(y, g, mean)
    _dispatch.check_pixels(*y.shape[:3])
    y = y.contiguous()
    g = (g if g.dtype == y.dtype else g.to(y.dtype)).contiguous()
    vecs = [t if t.dtype == torch.float32 and t.is_contiguous() else t.float().contiguous()
            for t in (mean, rstd, gamma, beta)]
    return y, g, vecs


def _schedule(y, c, vec):
    m = y.shape[0] * y.shape[1] * y.shape[2]
    return row_schedule(m, row_lanes(c, 16 // _ITEM_BYTES[y.dtype] if vec else 1))


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
    y, g, (mean, rstd, gamma, beta) = _prepare(y, g, mean, rstd, gamma, beta)
    code_dt = _dispatch.dtype_code(y.dtype)
    n, h, w, c = y.shape
    m = n * h * w
    dx = torch.empty_like(y)
    if m == 0 or c == 0:
        zeros = torch.zeros(c, dtype=torch.float32, device=y.device)
        return dx, zeros, zeros.clone()
    vec = vector_route(y.dtype, c, y.data_ptr(), g.data_ptr(), dx.data_ptr())
    chunk, blocks = _schedule(y, c, vec)
    part = torch.empty((blocks, 2 * c), dtype=torch.float32, device=y.device)
    sums = torch.empty(2 * c, dtype=torch.float32, device=y.device)
    with _dispatch.on_device(y.device):
        check(load_library().sfh_bn_relu_bwd(
            y.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), part.data_ptr(), sums.data_ptr(),
            dx.data_ptr(), m, c, chunk, int(vec), code_dt,
            _dispatch.stream_handle(y.device)), "bn_relu_bwd")
    bn_relu_bwd.launches += 1
    bn_relu_bwd.vec_launches += vec
    return dx, sums[c:], sums[:c]


def bn_relu_bwd_sums(y: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                     rstd: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor) -> torch.Tensor:
    """The first half of the split backward: the (2C,) f32 sums
    ``[dbeta | dgamma]`` over this call's N*H*W rows (K7-bwd's pass 1 and
    its fixed-order finish: two launches).  Arguments as ``bn_relu_bwd``."""
    if _dispatch.on_cpu(y, g, mean, rstd, gamma, beta):
        return bn_relu_bwd_sums_plain(y, g, mean, rstd, gamma, beta)
    y, g, (mean, rstd, gamma, beta) = _prepare(y, g, mean, rstd, gamma, beta)
    code_dt = _dispatch.dtype_code(y.dtype)
    n, h, w, c = y.shape
    m = n * h * w
    sums = torch.zeros(2 * c, dtype=torch.float32, device=y.device)
    if m == 0 or c == 0:
        return sums
    vec = vector_route(y.dtype, c, y.data_ptr(), g.data_ptr())
    chunk, blocks = _schedule(y, c, vec)
    part = torch.empty((blocks, 2 * c), dtype=torch.float32, device=y.device)
    with _dispatch.on_device(y.device):
        check(load_library().sfh_bn_relu_bwd_sums(
            y.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), part.data_ptr(), sums.data_ptr(),
            m, c, chunk, int(vec), code_dt, _dispatch.stream_handle(y.device)),
            "bn_relu_bwd_sums")
    bn_relu_bwd_sums.launches += 1
    bn_relu_bwd_sums.vec_launches += vec
    return sums


def bn_relu_bwd_dx(y: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   sums: torch.Tensor, m_total: int) -> torch.Tensor:
    """The second half: dx in y's dtype for this call's rows, from the
    (2C,) ``sums`` over ``m_total`` rows (the all-reduced
    ``bn_relu_bwd_sums`` of every rank, and their global count): K7-bwd's
    dx pass, one launch."""
    if _dispatch.on_cpu(y, g, mean, rstd, gamma, beta, sums):
        return bn_relu_bwd_dx_plain(y, g, mean, rstd, gamma, beta, sums, m_total)
    y, g, (mean, rstd, gamma, beta) = _prepare(y, g, mean, rstd, gamma, beta)
    code_dt = _dispatch.dtype_code(y.dtype)
    n, h, w, c = y.shape
    m = n * h * w
    if sums.shape != (2 * c,):
        raise ValueError(f"sums must be ({2 * c},), got {tuple(sums.shape)}")
    if not m <= m_total < 2 ** 31:
        raise ValueError(f"m_total {m_total} must be in [{m}, 2**31)")
    sums = sums.float().contiguous()
    dx = torch.empty_like(y)
    if m == 0 or c == 0:
        return dx
    vec = vector_route(y.dtype, c, y.data_ptr(), g.data_ptr(), dx.data_ptr())
    chunk, _ = _schedule(y, c, vec)
    with _dispatch.on_device(y.device):
        check(load_library().sfh_bn_relu_bwd_dx(
            y.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), sums.data_ptr(), dx.data_ptr(),
            m, c, chunk, int(vec), code_dt, int(m_total),
            _dispatch.stream_handle(y.device)), "bn_relu_bwd_dx")
    bn_relu_bwd_dx.launches += 1
    bn_relu_bwd_dx.vec_launches += vec
    return dx


bn_relu_bwd.launches = 0
bn_relu_bwd.vec_launches = 0    # the subset of calls on the 16-byte route
bn_relu_bwd_sums.launches = 0
bn_relu_bwd_sums.vec_launches = 0
bn_relu_bwd_dx.launches = 0
bn_relu_bwd_dx.vec_launches = 0
