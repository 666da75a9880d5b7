"""K2: 3x3, pad-1 convolution over NHWC, with bias, an optional BN+ReLU
prologue on the input and an optional stats epilogue on the output.

Port of ``ops/conv3x3_pallas.py::conv3x3``.  The CUDA kernel is
``csrc/conv3x3.cu``: an implicit GEMM with f32 accumulation and one
rounding of ``conv + bias`` to the input dtype.  With ``stats=True`` it
also returns the (2, Cout) f32 sums ``[sum(y), sum(y*y)]`` over N*H*W,
taken on the f32 accumulator after the bias and before the rounding
(the BatchNorm batch statistics of the training DoubleConv); the block
partials are added by ``ops/reduce.column_sums`` in a fixed order.

The plain version is ``F.conv2d`` in the input dtype, with the bias added
in f32; given float32 copies of bf16 inputs it computes the kernel's bf16
result before that last rounding.  With ``stats`` it runs the conv in f32
on the (bf16-valued) inputs, adds the bias, takes the sums and then
rounds, as the kernel does.

A dgrad needs no kernel of its own: it is this conv, without bias, over
the cotangent with ``dgrad_weights`` (rot180, channel-transposed).

Two-input form (``x2``/``w2``, the concat-free decoder conv of
``conv3x3_pallas.conv3x3``'s ``x2``/``wmat2``): ``conv(cat(x, x2), cat(w,
w2))`` as ``conv(x, w) + conv(x2, w2)`` in one kernel pass, the K loop
running over x's 9*Cin rows and then over x2's 9*Cin2 rows into the same
accumulator.  The prologue applies to x only, the bias is added once and
the stats are those of the sum.  Its plain version concatenates.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import _dispatch
from .build import check, load_library
from .reduce import column_sums

__all__ = ["conv3x3", "conv3x3_plain", "apply_prologue", "dgrad_weights"]

_ROWS_PER_BLOCK = 64         # kBM in csrc/tile_gemm.cuh


def dgrad_weights(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) HWIO -> (3, 3, Cout, Cin): the weights whose
    conv3x3 over the cotangent is the input gradient,
    dx[p] = sum_k dy[p + 1 - k] W[k] (``conv3x3_pallas.dgrad_weights``)."""
    return w.flip(0, 1).transpose(2, 3)


def apply_prologue(x: torch.Tensor, prologue) -> torch.Tensor:
    """relu((x - mean) * inv + beta) per channel (last axis), computed in
    f32 and rounded back to x's dtype."""
    mean, inv, beta = prologue
    acc = _dispatch.acc_dtype(x.dtype)
    return torch.relu((x.to(acc) - mean) * inv + beta).to(x.dtype)


def _check(x, w):
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, Cin), got {tuple(x.shape)}")
    cin = x.shape[-1]
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w must be (3, 3, {cin}, Cout), got {tuple(w.shape)}")


def _check_second(x, w, x2, w2):
    if (x2 is None) != (w2 is None):
        raise ValueError("x2 and w2 come together")
    if x2 is None:
        return
    _check(x2, w2)
    if x2.shape[:3] != x.shape[:3] or w2.shape[-1] != w.shape[-1]:
        raise ValueError(f"x2 {tuple(x2.shape)} / w2 {tuple(w2.shape)} must share N, H, "
                         f"W with x {tuple(x.shape)} and Cout with w {tuple(w.shape)}")
    if x2.dtype != x.dtype:
        raise TypeError(f"x2 ({x2.dtype}) must have x's dtype ({x.dtype})")


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  prologue: Optional[Sequence[torch.Tensor]] = None,
                  stats: bool = False, x2: Optional[torch.Tensor] = None,
                  w2: Optional[torch.Tensor] = None):
    _check(x, w)
    _check_second(x, w, x2, w2)
    if prologue is not None:
        x = apply_prologue(x, prologue)
    if x2 is not None:
        x, w = torch.cat([x, x2], dim=-1), torch.cat([w, w2.to(w.dtype)], dim=2)
    dt = x.dtype
    acc = _dispatch.acc_dtype(dt)
    if stats:
        x, w = x.to(acc), w.to(dt).to(acc)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 padding=1).permute(0, 2, 3, 1)
    if bias is not None:
        y = y.to(acc) + bias.to(acc)
    if stats:
        y = y.to(acc)
        sums = torch.stack([y.sum(dim=(0, 1, 2)), (y * y).sum(dim=(0, 1, 2))])
        return y.to(dt).contiguous(), sums
    return y.to(dt).contiguous()


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            bias: Optional[torch.Tensor] = None,
            prologue: Optional[Sequence[torch.Tensor]] = None,
            stats: bool = False, x2: Optional[torch.Tensor] = None,
            w2: Optional[torch.Tensor] = None):
    """y = conv3x3(prologue(x), w) [+ conv3x3(x2, w2)] + bias over NHWC.

    Args:
      x: (N, H, W, Cin) float32 or bfloat16.
      w: (3, 3, Cin, Cout) HWIO weights (cast to x's dtype).
      bias: (Cout,) or None; added in f32.
      prologue: optional (mean, inv, beta) per-input-channel vectors;
        applies relu((x - mean) * inv + beta) to x first.  The zero padding
        stays zero.
      stats: also return the (2, Cout) f32 sums [sum(y), sum(y*y)] over
        N*H*W, of the f32 result before its rounding to x's dtype.
      x2, w2: optional second input (N, H, W, Cin2) in x's dtype and its
        (3, 3, Cin2, Cout) weights, summed into the same output (the conv
        of the channel concat [x, x2]); no prologue on x2.
    Returns:
      (N, H, W, Cout) in x's dtype, or (y, sums) with ``stats``.
    """
    extra = [bias] if bias is not None else []
    if prologue is not None:
        extra += list(prologue)
    extra += [t for t in (x2, w2) if t is not None]
    if _dispatch.on_cpu(x, w, *extra):
        return conv3x3_plain(x, w, bias, prologue, stats, x2, w2)
    _check(x, w)
    _check_second(x, w, x2, w2)
    code_dt = _dispatch.dtype_code(x.dtype)
    n, h, wd, cin = x.shape
    _dispatch.check_pixels(n, h, wd)
    cout = w.shape[-1]
    x = x.contiguous()
    wmat = w.to(x.dtype).contiguous()            # (9*Cin, Cout) row-major
    cin2 = 0 if x2 is None else x2.shape[-1]
    if x2 is not None:     # each input's slice of the weights packed on its own
        x2, w2 = x2.contiguous(), w2.to(x.dtype).contiguous()
    b = bias.float().contiguous() if bias is not None else None
    pro = ([t.float().contiguous() for t in prologue]
           if prologue is not None else [None, None, None])
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    m = n * h * wd
    if y.numel() == 0:
        zeros = torch.zeros((2, cout), dtype=torch.float32, device=x.device)
        return (y, zeros) if stats else y
    part = (torch.empty((-(-m // _ROWS_PER_BLOCK), 2 * cout), dtype=torch.float32,
                        device=x.device) if stats else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x.device):
        code = load_library().sfh_conv3x3(
            x.data_ptr(), wmat.data_ptr(), ptr(x2), ptr(w2), ptr(b), ptr(pro[0]),
            ptr(pro[1]), ptr(pro[2]), y.data_ptr(), ptr(part), n, h, wd, cin, cin2,
            cout, code_dt, _dispatch.stream_handle(x.device))
    check(code, "conv3x3")
    conv3x3.launches += 1
    if x2 is not None:
        conv3x3.dual_launches += 1
    if not stats:
        return y
    conv3x3.stats_launches += 1
    return y, column_sums(part).view(2, cout)


conv3x3.launches = 0
conv3x3.stats_launches = 0    # the subset of launches with the stats epilogue
conv3x3.dual_launches = 0     # the subset of launches with a second input
