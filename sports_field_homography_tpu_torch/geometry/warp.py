"""Homography warp grids (port of ``geometry/warp.py``).

kornia's ``HomographyWarper`` as the reference uses it: a normalized
meshgrid over the output with endpoints included, mapped through theta,
then sampled with ``align_corners=False``.  The nearest sampler (predict)
is the kernel in ``ops/warp.py``; the bilinear one (training, where the
gradient reaches theta) is ``warp_bilinear``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.resize import nearest_index
from .homography import transform_points

__all__ = ["normalized_grid", "warp_grid", "subsampled_warp_grid",
           "warp_bilinear", "sample_bilinear", "warp_nearest_image", "_unnormalize"]


def _f32(v: float) -> float:
    """A Python float holding exactly the float32 rounding of v (what a
    float32 array times a Python float computes with)."""
    return float(np.float32(v))


def _axis(n: int, device) -> torch.Tensor:
    """[-1, 1] coordinates of n grid points, endpoints included:
    ``i * f32(2 / (n - 1)) - 1`` as the reference builds them."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    return i * _f32(2.0 / (n - 1)) - 1.0


def normalized_grid(height: int, width: int, device=None) -> torch.Tensor:
    """(H, W, 2) grid of (x, y) in [-1, 1] (kornia ``create_meshgrid``)."""
    xs = _axis(width, device)
    ys = _axis(height, device)
    return torch.stack([xs[None, :].expand(height, width),
                        ys[:, None].expand(height, width)], dim=-1)


def warp_grid(theta: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, H, W, 2) normalized source coordinates of the output grid.

    theta: (B, 3, 3) or (B, 1, 3, 3) f32 dst -> src homographies.
    """
    if theta.dim() == 4:
        theta = theta[:, 0]
    grid = normalized_grid(height, width, theta.device).reshape(1, -1, 2)
    pts = transform_points(theta, grid)
    return pts.reshape(theta.shape[0], height, width, 2)


def subsampled_warp_grid(theta: torch.Tensor, out_hw, sample_hw) -> torch.Tensor:
    """The out_hw warp grid evaluated only at the nearest-resize sample
    points of sample_hw (port of ``ops/interval_warp._warp_grid_subsampled``):
    warping with it equals warping at out_hw, then nearest-resizing."""
    if theta.dim() == 4:
        theta = theta[:, 0]
    ho, wo = out_hw
    hs, ws = sample_hw
    dev = theta.device
    xn = nearest_index(wo, ws, dev).float() * _f32(2.0 / (wo - 1)) - 1.0
    yn = nearest_index(ho, hs, dev).float() * _f32(2.0 / (ho - 1)) - 1.0
    grid = torch.stack([xn[None, :].expand(hs, ws),
                        yn[:, None].expand(hs, ws)], dim=-1).reshape(1, -1, 2)
    pts = transform_points(theta, grid)
    return pts.reshape(theta.shape[0], hs, ws, 2)


def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """[-1, 1] -> pixel coordinates, as ``grid_sample`` with
    ``align_corners=False``."""
    return ((coord + 1.0) * size - 1.0) * 0.5


def warp_bilinear(template: torch.Tensor, theta: torch.Tensor,
                  out_hw) -> torch.Tensor:
    """Bilinear homography warp of a (Ht, Wt) float template, or of one
    (B, Ht, Wt) template per sample: (B, Ho, Wo), zero outside it,
    differentiable in theta.

    ``grid_sample(mode='bilinear', padding_mode='zeros',
    align_corners=False)`` over the ``warp_grid`` (what the reference
    trains with), written as four gathers and two lerps in the order of the
    JAX training warp ``ops/interval_warp.warp_bilinear_interval``:
    ``top = v00 * (1 - tx) + v01 * tx``, then ``top * (1 - ty) + bot * ty``.
    The order matters: the consistency labels are ``trunc(warp * classes)``,
    and inside a class region the lerp of equal values lands one ulp
    either side of the value depending on it.  ``F.grid_sample``'s weight
    products flip 1.4 % of those labels against the JAX warp; this order
    flips none (CPU, float32).  The gradient reaches theta through the
    lerp weights.
    """
    if theta.dim() == 4:
        theta = theta[:, 0]
    grid = warp_grid(theta, *out_hw)
    return sample_bilinear(template, grid)


def sample_bilinear(template: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``grid_sample(mode='bilinear', padding_mode='zeros',
    align_corners=False)`` of a (Ht, Wt) float template, or of one
    (B, Ht, Wt) template per sample, at the (B, Ho, Wo, 2) normalized
    (x, y) of ``grid``: (B, Ho, Wo), zero outside the template.  Four
    gathers and two lerps, each operation rounded on its own, in the JAX
    package's order (``warp_bilinear`` says why the order matters); the
    CPU and CUDA give the same bits."""
    ht, wt = template.shape[-2:]
    u = _unnormalize(grid[..., 0], wt)
    v = _unnormalize(grid[..., 1], ht)
    u0, v0 = torch.floor(u), torch.floor(v)
    tx, ty = u - u0, v - v0
    flat = template.to(grid.dtype).reshape(-1)
    zero = torch.zeros((), dtype=grid.dtype, device=grid.device)
    # each sample's own template starts ht * wt further on
    base = (0 if template.dim() == 2 else
            torch.arange(grid.shape[0], device=grid.device).view(-1, 1, 1) * (ht * wt))

    def corner(row, col):
        valid = (col >= 0) & (col < wt) & (row >= 0) & (row < ht)
        idx = row.clamp(0, ht - 1).long() * wt + col.clamp(0, wt - 1).long() + base
        return torch.where(valid, flat[idx], zero)

    top = corner(v0, u0) * (1.0 - tx) + corner(v0, u0 + 1.0) * tx
    bot = corner(v0 + 1.0, u0) * (1.0 - tx) + corner(v0 + 1.0, u0 + 1.0) * tx
    return top * (1.0 - ty) + bot * ty


def warp_nearest_image(img: torch.Tensor, theta: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest homography warp of a (B, Ht, Wt, C) float image:
    (B, Ho, Wo, C), 0 outside it.

    ``grid_sample(mode='nearest', padding_mode='zeros',
    align_corners=False)`` over the ``warp_grid``, as the JAX package's
    ``warp_homography(mode='nearest')``: coordinates rounded half to even,
    then one gather.  Unlike K1 (``ops/warp.py``) it warps any float
    image, not a uint8 label map.
    """
    if theta.dim() == 4:
        theta = theta[:, 0]
    b, ht, wt, c = img.shape
    grid = warp_grid(theta.float(), *out_hw)
    iu = torch.round(_unnormalize(grid[..., 0], wt))
    iv = torch.round(_unnormalize(grid[..., 1], ht))
    valid = (iu >= 0) & (iu < wt) & (iv >= 0) & (iv < ht)
    lin = iv.clamp(0, ht - 1).long() * wt + iu.clamp(0, wt - 1).long()
    lin = lin + torch.arange(b, device=img.device).view(-1, 1, 1) * (ht * wt)
    out = img.float().reshape(-1, c)[lin]
    return torch.where(valid[..., None], out, torch.zeros((), device=img.device))
