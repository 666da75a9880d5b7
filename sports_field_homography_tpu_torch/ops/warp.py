"""K1: nearest homography warp of the court label template.

``warp_nearest`` is the port of ``ops/warp_pallas.py::
warp_nearest_interval_pallas`` and of its XLA twin
``ops/interval_warp.py::warp_nearest_interval``: for every output pixel
(or every ``sample_hw`` sample) it maps the normalized frame point through
theta, rounds to the nearest template pixel and returns
``label * value_step``, or 0 outside the template.  The CUDA kernel is
``csrc/warp_nearest.cu``; the plain version below computes the same
coordinates with the same rounding, so the two agree label for label.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry.warp import _unnormalize, subsampled_warp_grid, warp_grid
from . import _dispatch
from .build import check, load_library

__all__ = ["warp_nearest", "warp_nearest_plain", "template_value_step"]


def template_value_step(labels: np.ndarray, num_classes: int) -> float:
    """The value spacing of the float template ``labels / num_classes``:
    the smallest positive gap between its distinct values, in float32, as
    ``ops/interval_warp.build_interval_table`` chooses it.  The warp's
    output times ``num_classes`` is then the label again."""
    vals = np.unique(np.asarray(labels)).astype(np.float32) / float(num_classes)
    diffs = np.diff(np.unique(vals))
    step = diffs[diffs > 0].min() if (diffs > 0).any() else 1.0
    return float(np.float32(step))


def _check_args(template_labels, theta):
    if template_labels.dtype != torch.uint8 or template_labels.dim() != 2:
        raise TypeError("template_labels must be a (Ht, Wt) uint8 tensor, got "
                        f"{template_labels.dtype} {tuple(template_labels.shape)}")
    if theta.dim() == 4:
        theta = theta[:, 0]
    if theta.dim() != 3 or tuple(theta.shape[1:]) != (3, 3):
        raise ValueError(f"theta must be (B, 3, 3) or (B, 1, 3, 3), got "
                         f"{tuple(theta.shape)}")
    return theta.float()


def warp_nearest_plain(template_labels: torch.Tensor, theta: torch.Tensor,
                       out_hw, sample_hw=None,
                       value_step: float = 1.0) -> torch.Tensor:
    """Plain PyTorch nearest warp: index arithmetic plus a gather."""
    theta = _check_args(template_labels, theta)
    ht, wt = template_labels.shape
    if sample_hw is not None:
        grid = subsampled_warp_grid(theta, out_hw, sample_hw)
    else:
        grid = warp_grid(theta, *out_hw)
    iu = torch.round(_unnormalize(grid[..., 0], wt))   # half to even
    iv = torch.round(_unnormalize(grid[..., 1], ht))
    valid = (iu >= 0) & (iu < wt) & (iv >= 0) & (iv < ht)
    zero = torch.zeros_like(iu)
    lin = (torch.where(valid, iv, zero).long() * wt
           + torch.where(valid, iu, zero).long())
    labels = template_labels.reshape(-1)[lin].float()
    return torch.where(valid, labels * value_step, zero)


def warp_nearest(template_labels: torch.Tensor, theta: torch.Tensor, out_hw,
                 sample_hw=None, value_step: float = 1.0) -> torch.Tensor:
    """Nearest homography warp of a uint8 label template.

    Args:
      template_labels: (Ht, Wt) uint8 class labels.
      theta: (B, 3, 3) or (B, 1, 3, 3) frame -> court homographies; used in
        float32 whatever the model's compute dtype.
      out_hw: (Ho, Wo) output grid.
      sample_hw: optional (Hs, Ws): evaluate only the nearest-resize sample
        points of the out_hw grid, which equals warping at out_hw and then
        nearest-resizing to sample_hw.
      value_step: the output is ``label * value_step`` (f32).
    Returns:
      (B, Ho, Wo) or (B, Hs, Ws) float32, zero outside the template.
    """
    if _dispatch.on_cpu(template_labels, theta):
        return warp_nearest_plain(template_labels, theta, out_hw, sample_hw,
                                  value_step)
    theta = _check_args(template_labels, theta).contiguous()
    tmpl = template_labels.contiguous()
    ht, wt = tmpl.shape
    full_h, full_w = out_hw
    ho, wo = sample_hw if sample_hw is not None else out_hw
    b = theta.shape[0]
    out = torch.empty((b, ho, wo), dtype=torch.float32, device=theta.device)
    if out.numel() == 0:
        return out
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    with torch.cuda.device(out.device):
        code = load_library().sfh_warp_nearest(
            tmpl.data_ptr(), ht, wt, theta.data_ptr(), b, ho, wo, full_h,
            full_w, int(sample_hw is not None), f32(2.0 / (full_w - 1)),
            f32(2.0 / (full_h - 1)), f32(full_w / wo), f32(full_h / ho),
            f32(value_step), out.data_ptr(), _dispatch.stream_handle(out.device))
    check(code, "warp_nearest")
    warp_nearest.launches += 1
    return out


warp_nearest.launches = 0
