"""Homography algebra on tensors, in normalized ([-1, 1]) coordinates.

Port of ``sports_field_homography_tpu/geometry/homography.py``: theta is a
(..., 3, 3) frame -> court homography, as in the reference's kornia calls.
"""
from __future__ import annotations

import torch

__all__ = ["transform_points"]


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
