"""Operations and bytes of the model's layers, counted from shapes.

Every convolution, transposed convolution and linear layer of one frame's
forward pass is listed with its kind, its multiply-adds and its tensor
sizes.  A FLOP is two per multiply-add.  Bytes count each input element
read once, each output element written once and the weights once, at the
element sizes given: what any kernel computing the operation must move at
the least, whatever it reads again.  BatchNorm, activations, pooling and
the warp are not counted as FLOPs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

__all__ = ["Layer", "unet_layers", "resnet_layers", "model_layers", "forward_flops",
           "layer_work", "conv3x3_work", "wgrad3x3_work", "bound_seconds"]


@dataclass(frozen=True)
class Layer:
    name: str
    kind: str          # conv3x3 | stem | deconv2x2 | head | stn_conv | stn_linear
    macs: int          # multiply-adds for one frame
    inputs: int        # input elements for one frame
    outputs: int       # output elements for one frame
    weights: int       # weight elements


def _conv(name, kind, h, w, cin, cout, k, stride=1, pad=0):
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    return Layer(name, kind, ho * wo * cin * cout * k * k, h * w * cin, ho * wo * cout,
                 cin * cout * k * k), ho, wo


def unet_layers(h: int, w: int, bilinear: bool, classes: int) -> List[Layer]:
    """milesial's UNet: widths 64..1024 (the deepest halved when
    bilinear); the decoder convs read the skip and the up-sampled map as
    one concatenated input."""
    f = 2 if bilinear else 1
    out: List[Layer] = []

    def double(prefix, hh, ww, cin, cout, mid=None, first_kind="conv3x3"):
        mid = mid or cout
        out.append(_conv(f"{prefix}.0", first_kind, hh, ww, cin, mid, 3, 1, 1)[0])
        out.append(_conv(f"{prefix}.3", "conv3x3", hh, ww, mid, cout, 3, 1, 1)[0])

    sizes = [(h, w)]
    double("inc", h, w, 3, 64, first_kind="stem")
    chans = [64]
    for i, cout in enumerate((128, 256, 512, 1024 // f)):
        hh, ww = sizes[-1][0] // 2, sizes[-1][1] // 2
        sizes.append((hh, ww))
        double(f"down{i + 1}", hh, ww, chans[-1], cout)
        chans.append(cout)
    cur = chans[-1]
    for i, (cin, cout) in enumerate(((1024, 512 // f), (512, 256 // f), (256, 128 // f),
                                     (128, 64))):
        (hs, ws), (hl, wl) = sizes[3 - i], sizes[4 - i]
        if bilinear:
            double(f"up{i + 1}", hs, ws, cin, cout, mid=cin // 2)
        else:
            out.append(Layer(f"up{i + 1}.up", "deconv2x2", 4 * hl * wl * cur * (cin // 2),
                             hl * wl * cur, 4 * hl * wl * (cin // 2), cur * (cin // 2) * 4))
            double(f"up{i + 1}", hs, ws, cin, cout)
        cur = cout
    out.append(_conv("outc", "head", h, w, 64, classes, 1)[0])
    return out


_RESNETS = {"resnet18": ("basic", (2, 2, 2, 2)), "resnet34": ("basic", (3, 4, 6, 3)),
            "resnet50": ("bottleneck", (3, 4, 6, 3)), "resnet101": ("bottleneck", (3, 4, 23, 3))}


def resnet_layers(h: int, w: int, in_channels: int, name: str) -> List[Layer]:
    """torchvision's ResNet (v1.5 Bottleneck) on an (h, w) input, with a
    9-way head."""
    block, counts = _RESNETS[name]
    exp = 1 if block == "basic" else 4
    out: List[Layer] = []
    layer, h, w = _conv("conv0", "stn_conv", h, w, in_channels, 64, 7, 2, 3)
    out.append(layer)
    h, w = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1          # max-pool 3, stride 2, pad 1
    inplanes = 64
    for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), counts)):
        for b in range(n):
            s = 2 if (b == 0 and stage > 0) else 1
            p = f"layer{stage + 1}.{b}"
            if block == "basic":
                l1, ho, wo = _conv(f"{p}.conv1", "stn_conv", h, w, inplanes, planes, 3, s, 1)
                l2, _, _ = _conv(f"{p}.conv2", "stn_conv", ho, wo, planes, planes, 3, 1, 1)
                out += [l1, l2]
            else:
                l1, _, _ = _conv(f"{p}.conv1", "stn_conv", h, w, inplanes, planes, 1)
                l2, ho, wo = _conv(f"{p}.conv2", "stn_conv", h, w, planes, planes, 3, s, 1)
                l3, _, _ = _conv(f"{p}.conv3", "stn_conv", ho, wo, planes, planes * 4, 1)
                out += [l1, l2, l3]
            if b == 0 and (s != 1 or inplanes != planes * exp):
                out.append(_conv(f"{p}.downsample", "stn_conv", h, w, inplanes,
                                 planes * exp, 1, s)[0])
            inplanes = planes * exp
            h, w = ho, wo
    out.append(Layer("reg", "stn_linear", inplanes * 9, inplanes, 9, inplanes * 9))
    return out


def model_layers(model_cfg: dict) -> List[Layer]:
    """One frame's layers for a configuration file's ``model`` section."""
    w, h = model_cfg["unet_size"]
    classes = model_cfg["mask_classes"]
    tw, th = model_cfg["target_size"]
    return (unet_layers(h, w, model_cfg["unet_bilinear"], classes)
            + resnet_layers(th, tw, classes + 3, model_cfg["resnet_name"]))


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
