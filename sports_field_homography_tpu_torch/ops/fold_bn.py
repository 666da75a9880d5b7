"""Inference-time BatchNorm folding (port of ``ops/fold_bn.py``).

    y = (conv(x) + b - mean) * gamma / sqrt(var + eps) + beta
      = conv'(x) + b'    with W' = W * s, b' = (b - mean) * s + beta,
                              s  = gamma / sqrt(var + eps)

computed in float64 and stored in float32, as the JAX package does.  The
BN is then reset to scale 1, mean 0, var 1 - eps (var + eps rounds to
exactly 1 in float32), so eval BN degenerates to a per-channel add: zero
after a biased conv, the additive term after a bias-free one (ResNet).
The DoubleConv prologue still carries the ReLU.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["fold_batchnorm", "fold_pair"]

_EPS = 1e-5


@torch.no_grad()
def fold_pair(conv: nn.Module, bn: nn.BatchNorm2d) -> None:
    """Fold ``bn`` into ``conv`` (a Conv2d with OIHW weights) in place."""
    scale = bn.weight.double()
    bias = bn.bias.double()
    mean = bn.running_mean.double()
    var = bn.running_var.double()
    s = scale / torch.sqrt(var + _EPS)
    conv.weight.copy_((conv.weight.double() * s[:, None, None, None]).float())
    if conv.bias is not None:
        conv.bias.copy_(((conv.bias.double() - mean) * s + bias).float())
        bn.bias.zero_()
    else:
        bn.bias.copy_((bias - mean * s).float())
    bn.weight.fill_(1.0)
    bn.running_mean.zero_()
    bn.running_var.fill_(1.0 - _EPS)


def fold_batchnorm(model: nn.Module) -> nn.Module:
    """Fold every conv -> BN pair that ``model``'s submodules declare through
    a ``conv_bn_pairs()`` method; returns ``model`` (modified in place)."""
    for module in model.modules():
        pairs = getattr(module, "conv_bn_pairs", None)
        if pairs is not None:
            for conv, bn in pairs():
                fold_pair(conv, bn)
    return model
