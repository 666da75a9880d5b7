"""Checkpoints: the model's reference-keyed ``state_dict`` as a ``.pth``
(port of ``utils/checkpoint.py`` for the formats this port reads and
writes).  The file loads with ``strict=True`` into this port's
Reconstructor, and into the reference's, as the JAX package's
``save_torch_checkpoint`` output does.
"""
from __future__ import annotations

import os

import torch

__all__ = ["save_checkpoint"]


def save_checkpoint(path: str, model: torch.nn.Module) -> None:
    """``torch.save`` of the CPU copy of ``model.state_dict()``, written to
    a temporary file and renamed, so a failed save never truncates an
    existing checkpoint."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
