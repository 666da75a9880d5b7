"""Homography algebra on tensors, in normalized ([-1, 1]) coordinates.

Port of ``sports_field_homography_tpu/geometry/homography.py``: theta is a
(..., 3, 3) frame -> court homography, as in the reference's kornia calls.
"""
from __future__ import annotations

import torch

__all__ = ["transform_points", "inverse_3x3", "transform_poi",
           "normalize_points", "denormalize_points", "rescale_theta"]


_EPS = 1e-8


def transform_points(trans: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply batched homographies to 2D points with perspective division.

    kornia's ``transform_points``: divide by ``z + eps`` where ``|z| > eps``
    (eps = 1e-8), pass the point through unscaled elsewhere.

    The product is written out term by term, ``(t0*x + t1*y) + t2``, with
    every operation rounded on its own (no matmul, no fused multiply-add):
    the nearest warp rounds these coordinates, so its plain version and its
    CUDA kernel must compute them bit for bit alike.

    Args:
      trans:  (..., 3, 3) homographies.
      points: (..., N, 2) points.
    Returns:
      (..., N, 2) transformed points.
    """
    t = trans.unsqueeze(-3)                      # (..., 1, 3, 3)
    x, y = points[..., 0], points[..., 1]

    def row(i):
        return (t[..., i, 0] * x + t[..., i, 1] * y) + t[..., i, 2]

    px, py, pz = row(0), row(1), row(2)
    scale = torch.where(pz.abs() > _EPS, torch.reciprocal(pz + _EPS),
                        torch.ones_like(pz))
    return torch.stack([px * scale, py * scale], dim=-1)


def inverse_3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of batched (..., 3, 3) matrices, as
    the JAX package computes it (``geometry/homography.inverse_3x3``)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([A, -(b * i - c * h), (b * f - c * e),
                       B, (a * i - c * g), -(a * f - c * d),
                       C, -(a * h - b * g), (a * e - b * d)], dim=-1)
    return adj.reshape(*m.shape[:-2], 3, 3) / det[..., None, None]


def transform_poi(theta: torch.Tensor, court_poi: torch.Tensor,
                  normalize: bool = True) -> torch.Tensor:
    """Project court points of interest into the frame: ``inverse(theta)``
    (court -> frame), then [-1, 1] -> [0, 1] when ``normalize``.

    theta: (B, 3, 3) or (B, 1, 3, 3); court_poi: (N, 2) or (B, N, 2) in
    [-1, 1].  Returns (B, N, 2).
    """
    if theta.dim() == 4:
        theta = theta[:, 0]
    if court_poi.dim() == 2:
        court_poi = court_poi.expand(theta.shape[0], *court_poi.shape)
    poi = transform_points(inverse_3x3(theta), court_poi)
    return poi / 2.0 + 0.5 if normalize else poi


def normalize_points(points: torch.Tensor, size) -> torch.Tensor:
    """Pixel coordinates -> [-1, 1]; ``size`` is (W, H)."""
    scale = torch.tensor([2.0 / size[0], 2.0 / size[1]], dtype=points.dtype,
                         device=points.device)
    return points * scale - 1.0


def denormalize_points(points: torch.Tensor, size) -> torch.Tensor:
    """[0, 1] coordinates -> pixels; ``size`` is (W, H)."""
    return points * torch.tensor([float(size[0]), float(size[1])],
                                 dtype=points.dtype, device=points.device)


def rescale_theta(theta: torch.Tensor, src_size, dst_size) -> torch.Tensor:
    """Rescale a pixel-space homography between image resolutions:
    ``S_dst @ theta @ S_src^-1`` with per-axis scales, in theta's dtype.
    Sizes are (W, H)."""
    opts = dict(dtype=theta.dtype, device=theta.device)
    dst = torch.tensor([[float(dst_size[0]), 0.0, 0.0], [0.0, float(dst_size[1]), 0.0],
                        [0.0, 0.0, 1.0]], **opts)
    src_inv = torch.tensor([[1.0 / src_size[0], 0.0, 0.0], [0.0, 1.0 / src_size[1], 0.0],
                            [0.0, 0.0, 1.0]], **opts)
    return dst @ theta @ src_inv
