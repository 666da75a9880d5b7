"""K3: k2s2 transposed convolution (forward) over NHWC.

Port of ``ops/deconv_pallas.py::deconv2x2_packed`` with native output:
``y[n, 2i+p, 2j+q, o] = sum_c x[n, i, j, c] * W[c, p, q, o] + b[o]``.
The CUDA kernel is ``csrc/deconv2x2.cu`` (any H and W, f32 accumulation);
the plain version is ``F.conv_transpose2d`` in the input dtype with the
bias added in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _dispatch
from .build import check, load_library

__all__ = ["deconv2x2", "deconv2x2_plain"]


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


def deconv2x2(x: torch.Tensor, w: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d(k=2, s=2) over NHWC.

    Args:
      x: (N, H, W, Cin) float32 or bfloat16, any H and W.
      w: (Cin, 2, 2, Cout) weights (the JAX ``Deconv2x`` layout; a torch
        ConvTranspose2d weight is ``weight.permute(0, 2, 3, 1)``).
      bias: (Cout,), added in f32.
    Returns:
      (N, 2H, 2W, Cout) in x's dtype.
    """
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


deconv2x2.launches = 0
