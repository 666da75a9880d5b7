"""Loss maps and reductions (port of ``models/losses.py``).

All take NHWC maps and return the unreduced map where the reference uses
``reduction='none'``, so that ``per_sample_weighted`` can apply the
annotation-quality weights.  Every loss is computed in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["cross_entropy_map", "focal_loss_map", "mse_map", "smooth_l1_map",
           "reprojection_loss", "per_sample_weighted", "dice_coeff"]


def cross_entropy_map(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-pixel softmax cross entropy.

    logits: (B, H, W, C) raw scores (any float dtype, computed in f32);
    labels: (B, H, W) integer classes.  Returns (B, H, W) f32, equal to
    ``F.cross_entropy(logits_nchw, labels, reduction='none')``.
    """
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return lse - picked


def focal_loss_map(logits: torch.Tensor, labels: torch.Tensor,
                   alpha: float = 1.0, gamma: float = 2.0,
                   eps: float = 1e-8) -> torch.Tensor:
    """kornia 0.5 ``FocalLoss(reduction='none')``: with p = softmax + eps,
    ``-alpha * (1 - p_t)^gamma * log(p_t)`` at the label's class."""
    p = torch.softmax(logits.float(), dim=-1) + eps
    focal = -alpha * torch.pow(1.0 - p, gamma) * torch.log(p)
    one_hot = F.one_hot(labels.long(), logits.shape[-1]).float()
    return (one_hot * focal).sum(dim=-1)


def mse_map(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.square(pred.float() - target.float())


def smooth_l1_map(pred: torch.Tensor, target: torch.Tensor,
                  beta: float = 1.0) -> torch.Tensor:
    """``nn.SmoothL1Loss(reduction='none')`` with torch's default beta=1."""
    d = torch.abs(pred.float() - target.float())
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def reprojection_loss(inputs: torch.Tensor, targets: torch.Tensor,
                      nonzeros: torch.Tensor, num_nonzero: torch.Tensor,
                      reduction: str = "mean") -> torch.Tensor:
    """Masked mean point-to-point distance per sample (reference
    ``ReprojectionLoss``).  inputs/targets (B, N, 2); nonzeros (B, N) in
    {0, 1}; num_nonzero (B,)."""
    dist = torch.sqrt(torch.sum(torch.square(targets - inputs), dim=2))
    loss = torch.sum(dist * nonzeros, dim=1) / num_nonzero
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def per_sample_weighted(loss_map: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Per-sample mean times per-sample weight, then the batch mean."""
    per_sample = loss_map.mean(dim=tuple(range(1, loss_map.dim())))
    return (per_sample * weights.reshape(-1).to(per_sample.dtype)).mean()


def dice_coeff(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Batch mean of the per-sample dice coefficient
    ``(2 * sum(pred * target) + eps) / (sum(pred) + sum(target) + eps)``,
    in f32 (the legacy ``eval_net``'s score for one class)."""
    pred = pred.reshape(pred.shape[0], -1).float()
    target = target.reshape(target.shape[0], -1).float()
    inter = (pred * target).sum(dim=1)
    union = pred.sum(dim=1) + target.sum(dim=1) + eps
    return ((2.0 * inter + eps) / union).mean()
