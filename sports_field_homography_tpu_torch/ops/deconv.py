"""K3: k2s2 transposed convolution over NHWC, forward and backward.

Port of ``ops/deconv_pallas.py::deconv2x2_packed`` with native output:
``y[n, 2i+p, 2j+q, o] = sum_c x[n, i, j, c] * W[c, p, q, o] + b[o]``,
and K3-bwd (``_bwd_call``), which gives

    dx[n, i, j, c] = sum_{p, q, o} dy[n, 2i+p, 2j+q, o] * W[c, p, q, o]
    dW[c, p, q, o] = sum_{n, i, j} x[n, i, j, c] * dy[n, 2i+p, 2j+q, o]
    db[o]          = sum dy[..., o]

with dW and db in f32 (partials added by ``ops/reduce.column_sums`` in a
fixed order) and dx in x's dtype.  ``deconv2x2`` is differentiable through
``_Deconv2x2``, whose backward is K3-bwd.

Two CUDA routes, any H and W, f32 accumulation, chosen explicitly by dtype
and shape (``tensor_core_route``): bf16 with Cin and Cout multiples of 64
-- every up-conv of the deconv UNet -- runs ``csrc/deconv2x2_sm90.cu`` on
the tensor cores (wgmma); f32 and other channel counts run
``csrc/deconv2x2.cu`` on the CUDA cores.  Both read the weights as one of
two packs of the (Cin, 2, 2, Cout) weight: ``pack_weights`` (Cin, 4*Cout),
column (p*2 + q)*Cout + o (JAX's ``_parity_weights``), and its transpose
``pack_weights_t`` (4*Cout, Cin).  A tensor-core launch that fails raises;
it is never handed to the other kernel.

The forward is the operator ``sfh::deconv2x2`` (``ops/library.py``); the
backward, which only training runs, calls its kernel directly.

The plain versions are ``F.conv_transpose2d`` in the input dtype with the
bias added in f32, and for the backward ``F.conv2d`` (dx: a stride-2 conv
of dy with the same weights) plus an einsum in f32 for dW.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import _dispatch, library
from .build import check, load_library
from .conv3x3 import aligned
from .reduce import column_sums, split_reduction

__all__ = ["deconv2x2", "deconv2x2_plain", "deconv2x2_backward",
           "deconv2x2_backward_plain", "tensor_core_route", "pack_weights",
           "pack_weights_t", "tc_wgrad_split"]

_TC_STEP = 64          # pixels per K step of the tensor-core wgrad


def tensor_core_route(dtype: torch.dtype, cin: int, cout: int) -> bool:
    """True for the shapes ``csrc/deconv2x2_sm90.cu`` takes: bf16, Cin and
    Cout multiples of 64."""
    return (dtype == torch.bfloat16 and cin > 0 and cout > 0
            and cin % 64 == 0 and cout % 64 == 0)


def tc_wgrad_split(m: int, cin: int, cout: int):
    """(m_chunk, splits) of the tensor-core wgrad's pixel reduction over m
    input pixels: 64-pixel steps, (64, BN) tiles of the (Cin, 4*Cout) dW,
    BN = 128 when Cout allows it (``csrc/deconv2x2_sm90.cu``)."""
    return split_reduction(m, cin, 4 * cout, stage=_TC_STEP,
                           tile_cols=128 if cout % 128 == 0 else 64)


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """(Cin, 2, 2, Cout) -> (Cin, 4*Cout): row c holds W[c, p, q, o] at
    column (p*2 + q)*Cout + o (the SIMT forward's B, the tensor-core
    dgrad's K-major B)."""
    return w.reshape(w.shape[0], -1).contiguous()


def pack_weights_t(w: torch.Tensor) -> torch.Tensor:
    """(Cin, 2, 2, Cout) -> (4*Cout, Cin), ``pack_weights`` transposed (the
    SIMT dgrad's B, the tensor-core forward's K-major B)."""
    return w.reshape(w.shape[0], -1).t().contiguous()


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


def _deconv_cuda(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """sfh::deconv2x2 on CUDA: the kernel's launch, on the route
    ``tensor_core_route`` picks."""
    _dispatch.same_device(x, w, bias)
    _check(x, w, bias)
    code_dt = _dispatch.dtype_code(x.dtype)
    n, h, wd, cin = x.shape
    _dispatch.check_pixels(n, 2 * h, 2 * wd)
    cout = w.shape[-1]
    tc = tensor_core_route(x.dtype, cin, cout)
    b = bias.float().contiguous()
    y = torch.empty((n, 2 * h, 2 * wd, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = load_library()
    with torch.cuda.device(x.device):
        x = aligned(x)
        if tc:
            wt = aligned(pack_weights_t(w.to(x.dtype)))
            code = lib.sfh_deconv2x2_sm90(
                x.data_ptr(), wt.data_ptr(), b.data_ptr(), y.data_ptr(), n, h, wd, cin,
                cout, _dispatch.stream_handle(x.device))
        else:
            wpack = pack_weights(w.to(x.dtype))
            code = lib.sfh_deconv2x2(
                x.data_ptr(), wpack.data_ptr(), b.data_ptr(), y.data_ptr(), n, h,
                wd, cin, cout, code_dt, _dispatch.stream_handle(x.device))
    check(code, "deconv2x2 (tensor cores)" if tc else "deconv2x2")
    deconv2x2.launches += 1
    if tc:
        deconv2x2.tc_launches += 1
    return y


def _deconv_cpu(x, w, bias):
    _dispatch.same_device(x, w, bias)
    return deconv2x2_plain(x, w, bias)


def _deconv_fake(x, w, bias):
    _dispatch.same_device(x, w, bias)
    _check(x, w, bias)
    n, h, wd, _ = x.shape
    return x.new_empty((n, 2 * h, 2 * wd, w.shape[-1]))


_OP = library.define("deconv2x2(Tensor x, Tensor w, Tensor bias) -> Tensor",
                     _deconv_cpu, _deconv_cuda, _deconv_fake)


def _forward(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """K3 through ``sfh::deconv2x2``, the weights cast to x's dtype first."""
    _dispatch.on_cpu(x, w, bias)        # one device, CPU or CUDA
    return _OP(x, w.to(x.dtype), bias)


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
    tc = tensor_core_route(x.dtype, cin, cout)
    x, dy = aligned(x), aligned(dy.to(x.dtype))
    dx = torch.empty_like(x)
    if m == 0 or cout == 0:
        return (dx.zero_(), torch.zeros((cin, 2, 2, cout), device=x.device),
                torch.zeros(cout, device=x.device))
    chunk, splits = tc_wgrad_split(m, cin, cout) if tc else split_reduction(m, cin, 4 * cout)
    part = torch.empty((splits, cin * 4 * cout), dtype=torch.float32,
                       device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        if tc:
            wpack = aligned(pack_weights(w.to(x.dtype)))
            code = lib.sfh_deconv2x2_bwd_sm90(
                x.data_ptr(), dy.data_ptr(), wpack.data_ptr(), dx.data_ptr(),
                part.data_ptr(), n, h, wd, cin, cout, chunk, splits,
                _dispatch.stream_handle(x.device))
        else:
            wt = pack_weights_t(w.to(x.dtype))
            code = lib.sfh_deconv2x2_bwd(
                x.data_ptr(), dy.data_ptr(), wt.data_ptr(), dx.data_ptr(),
                part.data_ptr(), n, h, wd, cin, cout, chunk, splits, code_dt,
                _dispatch.stream_handle(x.device))
    check(code, "deconv2x2_backward (tensor cores)" if tc else "deconv2x2_backward")
    deconv2x2_backward.launches += 1
    if tc:
        deconv2x2_backward.tc_launches += 1
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
deconv2x2.tc_launches = 0             # the subset of launches on the tensor-core kernel
deconv2x2_backward.launches = 0
deconv2x2_backward.tc_launches = 0    # the same for K3-bwd
