"""K3: k2s2 transposed convolution over NHWC, forward and backward.

Port of ``ops/deconv_pallas.py::deconv2x2_packed`` with native output:
``y[n, 2i+p, 2j+q, o] = sum_c x[n, i, j, c] * W[c, p, q, o] + b[o]``.
The CUDA kernels are ``csrc/deconv2x2.cu`` (any H and W, f32
accumulation): the forward, and K3-bwd (``_bwd_call``), which gives

    dx[n, i, j, c] = sum_{p, q, o} dy[n, 2i+p, 2j+q, o] * W[c, p, q, o]
    dW[c, p, q, o] = sum_{n, i, j} x[n, i, j, c] * dy[n, 2i+p, 2j+q, o]
    db[o]          = sum dy[..., o]

with dW and db in f32 (partials added by ``ops/reduce.column_sums`` in a
fixed order) and dx in x's dtype.  ``deconv2x2`` is differentiable through
``_Deconv2x2``, whose backward is that kernel.

The plain versions are ``F.conv_transpose2d`` in the input dtype with the
bias added in f32, and for the backward ``F.conv2d`` (dx: a stride-2 conv
of dy with the same weights) plus an einsum in f32 for dW.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import _dispatch
from .build import check, load_library
from .reduce import column_sums, split_reduction

__all__ = ["deconv2x2", "deconv2x2_plain", "deconv2x2_backward",
           "deconv2x2_backward_plain"]


def _check(x, w, bias):
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, Cin), got {tuple(x.shape)}")
    cin = x.shape[-1]
    if w.dim() != 4 or w.shape[0] != cin or tuple(w.shape[1:3]) != (2, 2):
        raise ValueError(f"w must be ({cin}, 2, 2, Cout), got {tuple(w.shape)}")
    if bias.shape != (w.shape[-1],):
        raise ValueError(f"bias must be ({w.shape[-1]},), got {tuple(bias.shape)}")


def deconv2x2_plain(x: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    _check(x, w, bias)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                           w.to(x.dtype).permute(0, 3, 1, 2), stride=2)
    y = y.permute(0, 2, 3, 1).float() + bias.float()
    return y.to(x.dtype).contiguous()


def _forward(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    if _dispatch.on_cpu(x, w, bias):
        return deconv2x2_plain(x, w, bias)
    _check(x, w, bias)
    code_dt = _dispatch.dtype_code(x.dtype)
    n, h, wd, cin = x.shape
    _dispatch.check_pixels(n, 2 * h, 2 * wd)
    cout = w.shape[-1]
    x = x.contiguous()
    wpack = w.to(x.dtype).contiguous()          # (Cin, 4*Cout): col (p*2+q)*Cout+o
    b = bias.float().contiguous()
    y = torch.empty((n, 2 * h, 2 * wd, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        code = load_library().sfh_deconv2x2(
            x.data_ptr(), wpack.data_ptr(), b.data_ptr(), y.data_ptr(), n, h,
            wd, cin, cout, code_dt, _dispatch.stream_handle(x.device))
    check(code, "deconv2x2")
    deconv2x2.launches += 1
    return y


def _check_bwd(x, dy, w):
    n, h, wd, cin = x.shape
    if w.dim() != 4 or w.shape[0] != cin or tuple(w.shape[1:3]) != (2, 2):
        raise ValueError(f"w must be ({cin}, 2, 2, Cout), got {tuple(w.shape)}")
    if tuple(dy.shape) != (n, 2 * h, 2 * wd, w.shape[-1]):
        raise ValueError(f"dy must be {(n, 2 * h, 2 * wd, w.shape[-1])}, got "
                         f"{tuple(dy.shape)}")


def deconv2x2_backward_plain(x, dy, w):
    _check_bwd(x, dy, w)
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    wt = w.to(x.dtype)
    dx = F.conv2d(dy.to(x.dtype).permute(0, 3, 1, 2), wt.permute(0, 3, 1, 2),
                  stride=2).permute(0, 2, 3, 1)
    acc = _dispatch.acc_dtype(x.dtype)
    dy6 = dy.to(acc).reshape(n, h, 2, wd, 2, cout)
    dw = torch.einsum("nhwc,nhpwqo->cpqo", x.to(acc), dy6)
    return dx.to(x.dtype).contiguous(), dw.contiguous(), dy.to(acc).sum(dim=(0, 1, 2))


def deconv2x2_backward(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3-bwd: (dx in x's dtype, dW (Cin, 2, 2, Cout) f32, db (Cout,) f32)
    of ``deconv2x2(x, w, b)`` for the output cotangent dy (N, 2H, 2W, Cout)."""
    if _dispatch.on_cpu(x, dy, w):
        return deconv2x2_backward_plain(x, dy, w)
    _check_bwd(x, dy, w)
    code_dt = _dispatch.dtype_code(x.dtype)
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    m = n * h * wd
    _dispatch.check_pixels(n, 2 * h, 2 * wd)
    x = x.contiguous()
    dy = dy.to(x.dtype).contiguous()
    wt = w.to(x.dtype).reshape(cin, 4 * cout).t().contiguous()   # (4*Cout, Cin)
    dx = torch.empty_like(x)
    if m == 0 or cout == 0:
        return (dx.zero_(), torch.zeros((cin, 2, 2, cout), device=x.device),
                torch.zeros(cout, device=x.device))
    chunk, splits = split_reduction(m, cin, 4 * cout)
    part = torch.empty((splits, cin * 4 * cout), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        code = load_library().sfh_deconv2x2_bwd(
            x.data_ptr(), dy.data_ptr(), wt.data_ptr(), dx.data_ptr(),
            part.data_ptr(), n, h, wd, cin, cout, chunk, splits, code_dt,
            _dispatch.stream_handle(x.device))
    check(code, "deconv2x2_backward")
    deconv2x2_backward.launches += 1
    dw = part[0] if splits == 1 else column_sums(part)
    db = column_sums(dy.view(-1, cout))
    return dx, dw.view(cin, 2, 2, cout), db


class _Deconv2x2(torch.autograd.Function):
    """deconv2x2 with K3-bwd as its backward (the Pallas custom VJP,
    ``deconv_pallas.py:216-236``)."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        return _forward(x, w, bias)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw, db = deconv2x2_backward(x, dy, w)
        return dx, dw, db


def deconv2x2(x: torch.Tensor, w: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d(k=2, s=2) over NHWC, differentiable.

    Args:
      x: (N, H, W, Cin) float32 or bfloat16, any H and W.
      w: (Cin, 2, 2, Cout) weights (the JAX ``Deconv2x`` layout; a torch
        ConvTranspose2d weight is ``weight.permute(0, 2, 3, 1)``).
      bias: (Cout,), added in f32.
    Returns:
      (N, 2H, 2W, Cout) in x's dtype.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, bias)):
        return _Deconv2x2.apply(x, w, bias)
    return _forward(x, w, bias)


deconv2x2.launches = 0
deconv2x2_backward.launches = 0
