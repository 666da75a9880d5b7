"""K5: weight and bias gradients of the 3x3, pad-1 convolution over NHWC.

Port of ``ops/conv3x3_pallas.py::wgrad3x3``:
``dW[(ky, kx, ci), co] = sum_m patch(z)[m, (ky, kx, ci)] * dy[m, co]`` and
``db = sum_m dy[m, :]``, where ``z`` is the conv's input, or, with a
prologue, ``relu((x - mean) * inv + beta)`` recomputed from the saved
pre-BN input (padding cells stay zero).

The CUDA kernel is ``csrc/wgrad3x3.cu``: a tile GEMM whose pixel reduction
is split over blocks into f32 partials, added in a fixed order by
``ops/reduce.column_sums`` (deterministic, no float atomics); db is a
column sum of dy.  The plain version is ``torch.nn.grad.conv2d_weight``
(cuDNN on the card) in f32 on the (bf16-valued) inputs, which is what the
kernel accumulates.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import _dispatch
from .build import check, load_library
from .conv3x3 import apply_prologue
from .reduce import column_sums, split_reduction

__all__ = ["wgrad3x3", "wgrad3x3_plain"]


def _check(x, dy):
    if x.dim() != 4 or dy.dim() != 4 or x.shape[:3] != dy.shape[:3]:
        raise ValueError(f"x (N, H, W, Cin) and dy (N, H, W, Cout) must share "
                         f"N, H, W: {tuple(x.shape)} vs {tuple(dy.shape)}")


def wgrad3x3_plain(x: torch.Tensor, dy: torch.Tensor,
                   prologue: Optional[Sequence[torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(x, dy)
    if prologue is not None:
        x = apply_prologue(x, prologue)
    cin, cout = x.shape[-1], dy.shape[-1]
    acc = _dispatch.acc_dtype(x.dtype)
    dw = torch.nn.grad.conv2d_weight(
        x.to(acc).permute(0, 3, 1, 2), (cout, cin, 3, 3),
        dy.to(acc).permute(0, 3, 1, 2), padding=1)
    return dw.permute(2, 3, 1, 0).contiguous(), dy.to(acc).sum(dim=(0, 1, 2))


def wgrad3x3(x: torch.Tensor, dy: torch.Tensor,
             prologue: Optional[Sequence[torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weight and bias gradients of ``conv3x3(prologue(x), W) + b``.

    Args:
      x: (N, H, W, Cin) float32 or bfloat16, the conv's (pre-prologue) input.
      dy: (N, H, W, Cout) output cotangent, in x's dtype.
      prologue: optional (mean, inv, beta) per-input-channel vectors.
    Returns:
      (dW (3, 3, Cin, Cout) f32, db (Cout,) f32).
    """
    extra = list(prologue) if prologue is not None else []
    if _dispatch.on_cpu(x, dy, *extra):
        return wgrad3x3_plain(x, dy, prologue)
    _check(x, dy)
    if dy.dtype != x.dtype:
        raise TypeError(f"dy ({dy.dtype}) must have x's dtype ({x.dtype})")
    code_dt = _dispatch.dtype_code(x.dtype)
    n, h, wd, cin = x.shape
    cout = dy.shape[-1]
    m, k = n * h * wd, 9 * cin
    _dispatch.check_pixels(n, h, wd)
    if m == 0:
        zeros = torch.zeros((3, 3, cin, cout), dtype=torch.float32, device=x.device)
        return zeros, torch.zeros(cout, dtype=torch.float32, device=x.device)
    x = x.contiguous()
    dy = dy.contiguous()
    pro = ([t.float().contiguous() for t in prologue]
           if prologue is not None else [None, None, None])
    chunk, splits = split_reduction(m, k, cout)
    part = torch.empty((splits, k * cout), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x.device):
        code = load_library().sfh_wgrad3x3(
            x.data_ptr(), dy.data_ptr(), ptr(pro[0]), ptr(pro[1]), ptr(pro[2]),
            part.data_ptr(), n, h, wd, cin, cout, chunk, splits, code_dt,
            _dispatch.stream_handle(x.device))
    check(code, "wgrad3x3")
    wgrad3x3.launches += 1
    dw = part[0] if splits == 1 else column_sums(part)
    db = column_sums(dy.view(m, cout))
    return dw.view(3, 3, cin, cout), db


wgrad3x3.launches = 0
