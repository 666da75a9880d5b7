"""Per-pixel losses (port of ``models/losses.py``; inference slice only)."""
from __future__ import annotations

import torch

__all__ = ["cross_entropy_map"]


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
