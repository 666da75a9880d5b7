"""Shared layer helpers: BatchNorm (eval and train), NHWC <-> NCHW views,
seeded init.

The port keeps activations NHWC (what the CUDA kernels take).  cuDNN ops
(the ResNet, the UNet stem, max-pooling) run on ``x.permute(0, 3, 1, 2)``:
an NCHW view of NHWC memory, i.e. a channels-last tensor, which cuDNN
takes without a copy and returns in the same layout.

Modules carry the reference's parameter names and PyTorch layouts (OIHW
convs, IOHW transposed convs, ``nn.BatchNorm2d``), so reference ``.pth``
files and the JAX package's exported weights load with ``strict=True``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["BN_EPS", "BN_MOMENTUM", "bn_eval", "bn_train", "bn_apply",
           "update_running_stats", "set_bn_sync", "nchw", "nhwc", "max_pool",
           "init_weights"]

BN_EPS = 1e-5
BN_MOMENTUM = 0.1            # torch convention: weight of the new batch stat


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def bn_eval(x: torch.Tensor, bn: nn.BatchNorm2d, dim: int = 1) -> torch.Tensor:
    """Eval BatchNorm over channel axis ``dim``: computed in f32 as
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, cast back to x's
    dtype (the JAX package's ``batch_norm_apply``)."""
    shape = [1] * x.dim()
    shape[dim] = -1
    inv = torch.rsqrt(bn.running_var.float() + bn.eps) * bn.weight.float()
    y = ((x.float() - bn.running_mean.float().view(shape)) * inv.view(shape)
         + bn.bias.float().view(shape))
    return y.to(x.dtype)


@torch.no_grad()
def update_running_stats(bn: nn.BatchNorm2d, mean: torch.Tensor,
                         var: torch.Tensor, n: int) -> None:
    """``(1 - m) * running + m * stat`` with the unbiased variance
    ``var * n / (n - 1)`` (the JAX package's ``batch_norm_apply``, and
    torch's BatchNorm2d), plus ``num_batches_tracked``, in place."""
    m = BN_MOMENTUM
    unbiased = var.float() * (n / max(n - 1, 1))
    bn.running_mean.copy_((1.0 - m) * bn.running_mean + m * mean.float())
    bn.running_var.copy_((1.0 - m) * bn.running_var + m * unbiased)
    bn.num_batches_tracked.add_(1)


def bn_train(x: torch.Tensor, bn: nn.BatchNorm2d, dim: int = 1, sync=None) -> torch.Tensor:
    """Train-mode BatchNorm over channel axis ``dim``, differentiable.

    Moments in f32 as E[x] and E[x^2] - E[x]^2 (biased variance
    normalizes), then ``(x - mean) * (rsqrt(var + eps) * scale) + bias``
    cast back to x's dtype; the running stats update in place (the JAX
    package's ``batch_norm_apply`` in train mode).  With ``sync`` (a
    ``parallel/distributed.Replicas``; the JAX ``axis_name``) the moments
    are the global batch's: the per-channel sums of x and x^2 go through a
    differentiable all-reduce and are divided by the global count, so
    unequal shards are exact."""
    axes = tuple(a for a in range(x.dim()) if a != dim % x.dim())
    shape = [1] * x.dim()
    shape[dim] = -1
    xf = x.float()
    n = x.numel() // x.shape[dim]
    if sync is None:
        mean = xf.mean(dim=axes)
        var = (xf * xf).mean(dim=axes) - mean * mean
    else:
        n = sync.count(n)
        sums = sync.all_reduce(torch.stack([xf.sum(dim=axes), (xf * xf).sum(dim=axes)]))
        mean = sums[0] / n
        var = sums[1] / n - mean * mean
    update_running_stats(bn, mean.detach(), var.detach(), n)
    inv = torch.rsqrt(var + bn.eps) * bn.weight.float()
    y = (xf - mean.view(shape)) * inv.view(shape) + bn.bias.float().view(shape)
    return y.to(x.dtype)


def bn_apply(x: torch.Tensor, bn: nn.BatchNorm2d, training: bool,
             dim: int = 1, sync=None) -> torch.Tensor:
    return bn_train(x, bn, dim, sync) if training else bn_eval(x, bn, dim)


def set_bn_sync(model: nn.Module, sync) -> nn.Module:
    """Give every train-mode BatchNorm of ``model`` the data-parallel group
    ``sync`` (a ``parallel/distributed.Replicas``, or None for one device):
    the modules with a ``bn_sync`` attribute (the ResNet's blocks and stem,
    the UNet's DoubleConvs) pass it to their BatchNorm (the JAX
    ``model.clone(bn_axis_name="data")``)."""
    for m in model.modules():
        if hasattr(m, "bn_sync"):
            m.bn_sync = sync
    return model


def max_pool(x: torch.Tensor, window: int, stride: int,
             padding: int = 0) -> torch.Tensor:
    """MaxPool2d over an NHWC tensor; returns NHWC."""
    y = torch.nn.functional.max_pool2d(nchw(x), window, stride, padding)
    return nhwc(y).contiguous()


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every parameter from ``generator``, with the JAX
    package's initializers (``models/layers.py``, ``models/resnet.py``):

      * convs, transposed convs and linears: PyTorch's default,
        U(+-1/sqrt(fan_in)) for weight and bias;
      * modules that define ``reset_parameters_from(generator)`` override
        this (the ResNet's kaiming-normal convs and identity head);
      * BatchNorm: scale 1, bias 0, running mean 0, running var 1.
    """
    def uniform_(t, bound):
        t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1) * bound)

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            if isinstance(m, nn.ConvTranspose2d):   # JAX: (Cin, 2, 2, Cout)
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:
                fan_in = w[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            uniform_(w, bound)
            if m.bias is not None:
                uniform_(m.bias, bound)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    for m in model.modules():
        reset = getattr(m, "reset_parameters_from", None)
        if reset is not None:
            reset(generator)
    return model
