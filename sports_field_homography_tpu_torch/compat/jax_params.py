"""JAX-package variables -> this port's ``state_dict``.

A jax-free port of ``compat/torch_export.export_state_dict``: walks the
flax variable tree of the JAX ``Reconstructor`` (nested dicts of arrays,
``{"params": ..., "batch_stats": ...}``) or of a legacy model
(``models/legacy.py``: the UNet under ``core``, the head under ``reg``)
and emits the reference-keyed tensors the port's modules carry, so JAX
weights load with ``load_state_dict(..., strict=True)``.

Layouts: conv HWIO -> OIHW; transposed conv (I, H, W, O) -> IOHW;
linear (in, out) -> (out, in); BatchNorm scale/bias/mean/var ->
weight/bias/running_mean/running_var plus ``num_batches_tracked``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["state_dict_from_jax"]


def _leaf(x) -> np.ndarray:
    """A leaf as numpy; a bfloat16 tensor (``compat/flax_msgpack``) exactly,
    as float32."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x)


def _get(tree, path):
    node = tree
    for p in path:
        if node is None or p not in node:
            return None
        node = node[p]
    return node


def _conv(out, variables, path, name):
    p = _get(variables, ("params",) + path)
    if p is None or "kernel" not in p:
        return
    out[name + ".weight"] = _leaf(p["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in p:
        out[name + ".bias"] = _leaf(p["bias"])


def _bn(out, variables, path, name):
    p = _get(variables, ("params",) + path)
    s = _get(variables, ("batch_stats",) + path)
    if p is None:
        return
    out[name + ".weight"] = _leaf(p["scale"])
    out[name + ".bias"] = _leaf(p["bias"])
    if s is not None:
        out[name + ".running_mean"] = _leaf(s["mean"])
        out[name + ".running_var"] = _leaf(s["var"])
        out[name + ".num_batches_tracked"] = np.zeros((), np.int64)


def _double_conv(out, variables, path, name):
    """Sequential indices: 0 = conv1, 1 = bn1, 3 = conv2, 4 = bn2."""
    _conv(out, variables, path + ("conv1",), f"{name}.0")
    _bn(out, variables, path + ("bn1",), f"{name}.1")
    _conv(out, variables, path + ("conv2",), f"{name}.3")
    _bn(out, variables, path + ("bn2",), f"{name}.4")


def _dense(out, variables, path, name):
    p = _get(variables, ("params",) + path)
    if p is not None:
        out[name + ".weight"] = _leaf(p["kernel"]).T
        out[name + ".bias"] = _leaf(p["bias"])


def _arrays(variables: Dict) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    params = variables.get("params", {})
    # the Reconstructor's UNet is "unet", the legacy models' "core"
    for scope in ("unet", "core"):
        if scope not in params:
            continue
        u = (scope,)
        _double_conv(out, variables, u + ("inc",), "inc.double_conv")
        for i in range(1, 5):
            _double_conv(out, variables, u + (f"down{i}", "conv"),
                         f"down{i}.maxpool_conv.1.double_conv")
        for i in range(1, 5):
            up = _get(variables, ("params",) + u + (f"up{i}", "up"))
            if up is not None:
                out[f"up{i}.up.weight"] = _leaf(up["kernel"]).transpose(0, 3, 1, 2)
                out[f"up{i}.up.bias"] = _leaf(up["bias"])
            _double_conv(out, variables, u + (f"up{i}", "conv"),
                         f"up{i}.conv.double_conv")
        _conv(out, variables, u + ("outc", "conv"), "outc.conv")
        _conv(out, variables, u + ("outuv", "conv"), "outuv.conv")
    if "reg" in params:         # the legacy models' regression head
        _conv(out, variables, ("reg", "conv_reg"), "reg.conv_reg")
        _dense(out, variables, ("reg", "fc1"), "reg.fc1")
        _dense(out, variables, ("reg", "fc2"), "reg.fc2")
    if "resnet_reg" in params:
        r = ("resnet_reg",)
        _conv(out, variables, r + ("conv0",), "resnet_reg.conv0")
        _bn(out, variables, r + ("bn1",), "resnet_reg.bn1")
        for fname in sorted(params["resnet_reg"]):
            if not fname.startswith("layer"):
                continue
            stage, bi = fname[len("layer"):].split("_")
            tname = f"resnet_reg.layer{stage}.{bi}"
            for ci in (1, 2, 3):
                _conv(out, variables, r + (fname, f"conv{ci}"), f"{tname}.conv{ci}")
                _bn(out, variables, r + (fname, f"bn{ci}"), f"{tname}.bn{ci}")
            _conv(out, variables, r + (fname, "downsample_conv"), f"{tname}.downsample.0")
            _bn(out, variables, r + (fname, "downsample_bn"), f"{tname}.downsample.1")
        _dense(out, variables, r + ("reg",), "resnet_reg.reg")
    return out


def state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """Reference-keyed float32 tensors (int64 ``num_batches_tracked``)."""
    sd = {}
    for k, v in _arrays(variables).items():
        arr = np.asarray(v)
        if arr.dtype != np.int64:
            arr = arr.astype(np.float32)
        sd[k] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd
