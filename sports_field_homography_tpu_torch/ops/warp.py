"""K1: nearest homography warp of the court label template.

``warp_nearest`` is the port of ``ops/warp_pallas.py::
warp_nearest_interval_pallas`` and of its XLA twin
``ops/interval_warp.py::warp_nearest_interval``: for every output pixel
(or every ``sample_hw`` sample) it maps the normalized frame point through
theta, rounds to the nearest template pixel and returns that label's value
in a per-label f32 table (``template_value_table``: the value JAX's
interval table gives the label), or 0 outside the template.  The CUDA
kernel is ``csrc/warp_nearest.cu``; the plain version below computes the
same coordinates with the same rounding, so the two agree label for label.
The wrapper calls the operator ``sfh::warp_nearest`` (``ops/library.py``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..geometry.warp import _unnormalize, subsampled_warp_grid, warp_grid
from . import _dispatch, library
from .build import check, load_library

__all__ = ["warp_nearest", "warp_nearest_plain", "template_value_step",
           "template_value_table", "grid_constants", "vector_route"]

_LABELS = 256          # uint8 labels
_COLS = 4              # output columns a kernel thread stores as one float4


@functools.lru_cache(maxsize=None)
def grid_constants(out_hw, sample_hw=None):
    """(x_step, y_step, x_ratio, y_ratio): the f32 constants of the warp
    grid that ``geometry/warp.warp_grid`` and ``subsampled_warp_grid`` use,
    ``f32(2 / (full - 1))`` per axis and the nearest-resize ratio
    ``f32(full / sub)`` (1 without ``sample_hw``), as Python floats.
    ``out_hw`` and ``sample_hw`` are (H, W) tuples."""
    full_h, full_w = out_hw
    ho, wo = sample_hw if sample_hw is not None else out_hw
    return tuple(float(np.float32(v)) for v in
                 (2.0 / (full_w - 1), 2.0 / (full_h - 1), full_w / wo, full_h / ho))


def vector_route(wo: int, out_ptr: int) -> bool:
    """True where the kernel stores each thread's columns as one 16-byte
    float4: Wo a multiple of 4 and the output 16-byte aligned."""
    return wo % _COLS == 0 and out_ptr % 16 == 0


def template_value_step(labels: np.ndarray, num_classes: int) -> float:
    """The value spacing of the float template ``labels / num_classes``:
    the smallest positive gap between its distinct values, in float32, as
    ``ops/interval_warp.build_interval_table`` chooses it: the unit of
    the codes ``template_value_table`` multiplies back."""
    vals = np.unique(np.asarray(labels)).astype(np.float32) / float(num_classes)
    diffs = np.diff(np.unique(vals))
    step = diffs[diffs > 0].min() if (diffs > 0).any() else 1.0
    return float(np.float32(step))


def template_value_table(labels: np.ndarray, num_classes: int) -> torch.Tensor:
    """(256,) float32: the value the warp returns for each uint8 label, as
    ``ops/interval_warp.build_interval_table`` stores it for the float
    template ``labels / num_classes``: the code
    ``round(f32(label / num_classes) / step)`` times ``step``, in float32.
    For a template whose labels are evenly spaced from 0 (the NCAA court's
    0..3) that is ``label * step``; for one that skips a label it is not
    (labels {0, 2} of 4 classes: step 0.5, and label 2 gives 0.5)."""
    step = np.float32(template_value_step(labels, num_classes))
    vals = np.arange(_LABELS, dtype=np.float32) / float(num_classes)
    codes = np.round(vals / step)
    return torch.from_numpy((codes * step).astype(np.float32))


def _check_args(template_labels, theta, values):
    if values.dtype != torch.float32 or tuple(values.shape) != (_LABELS,):
        raise TypeError(f"values must be a ({_LABELS},) float32 table, got "
                        f"{values.dtype} {tuple(values.shape)}")
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
                       out_hw, values: torch.Tensor, sample_hw=None) -> torch.Tensor:
    """Plain PyTorch nearest warp: index arithmetic plus two gathers."""
    theta = _check_args(template_labels, theta, values)
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
    labels = template_labels.reshape(-1)[lin].long()
    return torch.where(valid, values[labels], zero)


def _warp_cuda(template_labels, theta, values, out_hw, sample_hw):
    """sfh::warp_nearest on CUDA: the kernel's launch."""
    _dispatch.same_device(template_labels, theta, values)
    theta = _check_args(template_labels, theta, values).contiguous()
    tmpl = template_labels.contiguous()
    values = values.contiguous()
    ht, wt = tmpl.shape
    out_hw = tuple(out_hw)
    sample_hw = None if sample_hw is None else tuple(sample_hw)
    full_h, full_w = out_hw
    ho, wo = sample_hw if sample_hw is not None else out_hw
    b = theta.shape[0]
    out = torch.empty((b, ho, wo), dtype=torch.float32, device=theta.device)
    if out.numel() == 0:
        return out
    vec = vector_route(wo, out.data_ptr())
    with _dispatch.on_device(out.device):
        code = load_library().sfh_warp_nearest(
            tmpl.data_ptr(), ht, wt, theta.data_ptr(), b, ho, wo, full_h, full_w,
            int(sample_hw is not None), *grid_constants(out_hw, sample_hw),
            values.data_ptr(), out.data_ptr(), int(vec), _dispatch.stream_handle(out.device))
    check(code, "warp_nearest")
    warp_nearest.launches += 1
    warp_nearest.vec_launches += vec
    return out


def _warp_cpu(template_labels, theta, values, out_hw, sample_hw):
    _dispatch.same_device(template_labels, theta, values)
    return warp_nearest_plain(template_labels, theta, tuple(out_hw), values,
                              None if sample_hw is None else tuple(sample_hw))


def _warp_fake(template_labels, theta, values, out_hw, sample_hw):
    _dispatch.same_device(template_labels, theta, values)
    theta = _check_args(template_labels, theta, values)
    ho, wo = sample_hw if sample_hw is not None else out_hw
    return theta.new_empty((theta.shape[0], ho, wo), dtype=torch.float32)


_OP = library.define(
    "warp_nearest(Tensor template_labels, Tensor theta, Tensor values, int[2] out_hw, "
    "int[2]? sample_hw) -> Tensor", _warp_cpu, _warp_cuda, _warp_fake)


def warp_nearest(template_labels: torch.Tensor, theta: torch.Tensor, out_hw,
                 values: torch.Tensor, sample_hw=None) -> torch.Tensor:
    """Nearest homography warp of a uint8 label template (``sfh::warp_nearest``).

    Args:
      template_labels: (Ht, Wt) uint8 class labels.
      theta: (B, 3, 3) or (B, 1, 3, 3) frame -> court homographies; used in
        float32 whatever the model's compute dtype.
      out_hw: (Ho, Wo) output grid.
      values: (256,) float32 value of each label (``template_value_table``).
      sample_hw: optional (Hs, Ws): evaluate only the nearest-resize sample
        points of the out_hw grid, which equals warping at out_hw and then
        nearest-resizing to sample_hw.
    Returns:
      (B, Ho, Wo) or (B, Hs, Ws) float32, zero outside the template.
    """
    _dispatch.on_cpu(template_labels, theta, values)    # one device, CPU or CUDA
    theta = _check_args(template_labels, theta, values)
    return _OP(template_labels, theta, values, [int(v) for v in out_hw],
               None if sample_hw is None else [int(v) for v in sample_hw])


warp_nearest.launches = 0
warp_nearest.vec_launches = 0    # the subset of launches on the float4 stores
