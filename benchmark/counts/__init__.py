"""Operations and bytes of the model's layers, counted from shapes.

Every convolution, transposed convolution and linear layer of one frame's
forward pass is listed with its kind, its multiply-adds and its tensor
sizes, read from the plain reference (``reference/model.py``) run on the
meta device: the shapes are written once, there.  A FLOP is two per
multiply-add.  Bytes count each input element read once, each output
element written once and the weights once, at the element sizes given:
what any kernel computing the operation must move at the least, whatever
it reads again.  BatchNorm, activations, pooling and the warp are not
counted as FLOPs.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, List

import torch
from torch import nn

import inputs

__all__ = ["Layer", "module_layers", "model_layers", "forward_flops", "layer_work",
           "conv3x3_work", "wgrad3x3_work", "bound_seconds"]


@dataclass(frozen=True)
class Layer:
    name: str
    kind: str          # conv3x3 | stem | deconv2x2 | head | stn_conv | stn_linear
    macs: int          # multiply-adds for one frame
    inputs: int        # input elements for one frame
    outputs: int       # output elements for one frame
    weights: int       # weight elements


def _layer(name: str, kind: str, mod: nn.Module, x: torch.Tensor, y: torch.Tensor) -> Layer:
    if isinstance(mod, nn.ConvTranspose2d):      # every input element feeds Cout x kh x kw
        macs = x.numel() * (mod.out_channels // mod.groups) * mod.weight[0, 0].numel()
    elif isinstance(mod, nn.Conv2d):
        macs = y.numel() * mod.weight[0].numel()       # (Cin / groups) x kh x kw an output
    else:
        macs = y.numel() * mod.in_features
    return Layer(name, kind, macs, x.numel(), y.numel(), mod.weight.numel())


def module_layers(model: nn.Module, kind: Callable[[str, nn.Module], str],
                  run: Callable[[], object]) -> List[Layer]:
    """The layers of ``model`` that ``run()`` calls, in the order they run;
    ``kind(name, module)`` names each one's kind."""
    out: List[Layer] = []
    hooks = []
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            def hook(m, a, y, name=name):
                out.append(_layer(name, kind(name, m), m, a[0], y))
            hooks.append(mod.register_forward_hook(hook))
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hooks:
            h.remove()
    return out


def _kind(name: str, mod: nn.Module) -> str:
    """A layer's kind from its place in the reference: the UNet's first conv
    is the stem, its ``up<i>.up`` the 2x2 up-convs, ``outc`` the 1x1 head,
    every other UNet conv a 3x3; the ResNet's convs and head."""
    if name.startswith("resnet_reg."):
        return "stn_linear" if isinstance(mod, nn.Linear) else "stn_conv"
    if name == "inc.double_conv.0":
        return "stem"
    if re.fullmatch(r"up\d+\.up", name):
        return "deconv2x2"
    return "head" if name.startswith("outc") else "conv3x3"


def model_layers(model_cfg: dict) -> List[Layer]:
    """One frame's layers for a configuration file's ``model`` section: the
    reference's UNet at ``unet_size`` and its ResNet on the logits and the
    image at ``target_size``."""
    model = inputs.reference_model(model_cfg, "meta")
    (w, h), (tw, th) = model_cfg["unet_size"], model_cfg["target_size"]
    c = model_cfg["mask_classes"] + 3
    with torch.device("meta"):
        x, xs = torch.empty(1, 3, h, w), torch.empty(1, c, th, tw)
    return module_layers(model, _kind, lambda: (model.unet(x), model.resnet_reg(xs)))


def forward_flops(model_cfg: dict) -> int:
    """FLOPs of one frame's forward pass."""
    return 2 * sum(layer.macs for layer in model_layers(model_cfg))


def layer_work(layer: Layer, batch: int, act_bytes: int, weight_bytes: int):
    """(FLOPs, bytes) of one layer over a batch: activations read and
    written once a frame, weights once a batch."""
    return (2 * layer.macs * batch,
            act_bytes * (layer.inputs + layer.outputs) * batch + weight_bytes * layer.weights)


def conv3x3_work(model_cfg: dict, batch: int, act_bytes: int, train: bool):
    """(FLOPs, bytes) of the UNet's 3x3 convolutions after the stem over a
    batch: the forward, and in training also the gradient of each input
    (the same products, over the output gradient, into the input's shape)."""
    flops = nbytes = 0
    passes = 2 if train else 1
    for layer in model_layers(model_cfg):
        if layer.kind == "conv3x3":
            f, b = layer_work(layer, batch, act_bytes, act_bytes)
            flops += passes * f
            nbytes += passes * b
    return flops, nbytes


def wgrad3x3_work(model_cfg: dict, batch: int, act_bytes: int, grad_bytes: int = 4):
    """(FLOPs, bytes) of the weight gradients of the same convs over a
    batch: the input and the output gradient read once, the weight
    gradient (``grad_bytes`` an element) written once."""
    flops = nbytes = 0
    for layer in model_layers(model_cfg):
        if layer.kind == "conv3x3":
            f, b = layer_work(layer, batch, act_bytes, grad_bytes)
            flops += f
            nbytes += b
    return flops, nbytes


def bound_seconds(flops: float, nbytes: float, peak_flops: float, peak_bytes: float) -> float:
    """The least time the card could take: operations at the peak rate or
    bytes at the peak bandwidth, whichever is longer."""
    return max(flops / peak_flops, nbytes / peak_bytes)
