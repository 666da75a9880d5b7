"""Optimizers and the plateau schedule (port of ``train/optim.py``).

The JAX package assembled optax chains to match ``torch.optim``:
elementwise gradient value clipping at 0.1, then weight decay coupled into
the gradient, then the optimizer's moments.  Here the optimizers are
torch's own: ``clip_gradients`` runs ``clip_grad_value_`` before
``optimizer.step()``, which adds ``weight_decay * p`` to the gradient
itself.  RMSprop: alpha 0.99, eps 1e-8 outside the square root, momentum
0.9; SGD: momentum 0.9; Adam: betas (0.9, 0.999), eps 1e-8.  The schedule
is torch's ``ReduceLROnPlateau(patience=3)`` stepped on the validation
reprojection error in pixels.
"""
from __future__ import annotations

from typing import Iterable

import torch

__all__ = ["make_optimizer", "make_scheduler", "clip_gradients",
           "GRAD_CLIP_VALUE"]

GRAD_CLIP_VALUE = 0.1


def make_optimizer(opt: str, params: Iterable[torch.nn.Parameter], lr: float,
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """The optimizer named like the reference's ``--opt``."""
    params = list(params)
    if opt == "RMSprop":
        return torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=1e-8,
                                   weight_decay=weight_decay, momentum=0.9)
    if opt == "SGD":
        return torch.optim.SGD(params, lr=lr, momentum=0.9,
                               weight_decay=weight_decay)
    if opt == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    raise NotImplementedError("optimizer {} does not support yet".format(opt))


def make_scheduler(optimizer: torch.optim.Optimizer):
    """torch's ReduceLROnPlateau as the reference builds it (mode 'min',
    factor 0.1, relative threshold 1e-4, patience 3)."""
    return torch.optim.lr_scheduler.ReduceLROnPlateau(optimizer, patience=3)


def clip_gradients(params: Iterable[torch.nn.Parameter],
                   value: float = GRAD_CLIP_VALUE) -> None:
    torch.nn.utils.clip_grad_value_(params, value)
