"""K2: 3x3, pad-1 convolution over NHWC, with bias and an optional
BN+ReLU prologue on the input.

Port of ``ops/conv3x3_pallas.py::conv3x3`` (forward).  The CUDA kernel is
``csrc/conv3x3.cu``: an implicit GEMM with f32 accumulation and one
rounding of ``conv + bias`` to the input dtype.  The plain version is
``F.conv2d`` in the input dtype, with the bias added in f32; given float32
copies of bf16 inputs it computes the kernel's bf16 result before that
last rounding.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import _dispatch
from .build import check, load_library

__all__ = ["conv3x3", "conv3x3_plain", "apply_prologue"]


def apply_prologue(x: torch.Tensor, prologue) -> torch.Tensor:
    """relu((x - mean) * inv + beta) per channel (last axis), computed in
    f32 and rounded back to x's dtype."""
    mean, inv, beta = prologue
    return torch.relu((x.float() - mean) * inv + beta).to(x.dtype)


def _check(x, w):
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, Cin), got {tuple(x.shape)}")
    cin = x.shape[-1]
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w must be (3, 3, {cin}, Cout), got {tuple(w.shape)}")


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  prologue: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    _check(x, w)
    if prologue is not None:
        x = apply_prologue(x, prologue)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 padding=1).permute(0, 2, 3, 1)
    if bias is not None:
        y = y.float() + bias.float()
    return y.to(x.dtype).contiguous()


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            bias: Optional[torch.Tensor] = None,
            prologue: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """y = conv3x3(prologue(x), w) + bias over NHWC.

    Args:
      x: (N, H, W, Cin) float32 or bfloat16.
      w: (3, 3, Cin, Cout) HWIO weights (cast to x's dtype).
      bias: (Cout,) or None; added in f32.
      prologue: optional (mean, inv, beta) per-input-channel vectors;
        applies relu((x - mean) * inv + beta) to x first.  The zero padding
        stays zero.
    Returns:
      (N, H, W, Cout) in x's dtype.
    """
    extra = [bias] if bias is not None else []
    if prologue is not None:
        extra += list(prologue)
    if _dispatch.on_cpu(x, w, *extra):
        return conv3x3_plain(x, w, bias, prologue)
    _check(x, w)
    code_dt = _dispatch.dtype_code(x.dtype)
    n, h, wd, cin = x.shape
    _dispatch.check_pixels(n, h, wd)
    cout = w.shape[-1]
    x = x.contiguous()
    wmat = w.to(x.dtype).contiguous()            # (9*Cin, Cout) row-major
    b = bias.float().contiguous() if bias is not None else None
    pro = ([t.float().contiguous() for t in prologue]
           if prologue is not None else [None, None, None])
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x.device):
        code = load_library().sfh_conv3x3(
            x.data_ptr(), wmat.data_ptr(), ptr(b), ptr(pro[0]), ptr(pro[1]),
            ptr(pro[2]), y.data_ptr(), n, h, wd, cin, cout, code_dt,
            _dispatch.stream_handle(x.device))
    check(code, "conv3x3")
    conv3x3.launches += 1
    return y


conv3x3.launches = 0
