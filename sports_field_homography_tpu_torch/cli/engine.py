"""Model construction for the CLIs (port of ``cli/engine.py``): build the
Reconstructor from parsed arguments, load its weights, fold BN, and load
the court constants onto the device.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..data.assets import open_court_template
from ..geometry.court import load_court_poi
from ..models import Reconstructor, ReconstructorConfig
from ..models.layers import init_weights
from ..ops.fold_bn import fold_batchnorm
from ..ops.warp import template_value_table
from ..utils.config import resolve_asset

__all__ = ["ModelBundle", "build_model", "discover_conf", "dtype_from_str"]


def dtype_from_str(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
            "float32": torch.float32, "f32": torch.float32}[str(name)]


@dataclass
class ModelBundle:
    model: Reconstructor
    court_labels: torch.Tensor        # (Ht, Wt) uint8 on the model's device
    value_table: torch.Tensor         # (256,) f32 label values, same device
    court_poi: np.ndarray             # (N, 2) in [-1, 1], host
    config: ReconstructorConfig
    device: torch.device


def build_model(args, load: Optional[str] = None, seed: int = 0,
                fold_bn: bool = False, warp_with_nearest: bool = False) -> ModelBundle:
    """Construct the Reconstructor and court constants from parsed args.

    ``load``: a reference-keyed ``.pth`` state_dict (the JAX package's
    ``save_torch_checkpoint`` writes these), loaded with ``strict=True``;
    None initialises from ``seed`` with a ``torch.Generator``.
    ``warp_with_nearest``: the forward warps with K1 (the test CLI).
    """
    device = torch.device(getattr(args, "device", "cuda"))
    dtype = dtype_from_str(getattr(args, "compute_dtype", "bfloat16"))
    if dtype == torch.float32:
        # parity mode: cuDNN convs and cuBLAS matmuls in full f32, not TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ReconstructorConfig(
        target_size=tuple(args.target_size), mask_classes=args.mask_classes,
        use_unet=args.use_unet, unet_bilinear=args.unet_bilinear,
        unet_size=tuple(args.unet_size), unet_uv=getattr(args, "unet_uv", False),
        use_resnet=args.use_resnet, resnet_name=args.resnet_name,
        resnet_input=args.resnet_input, use_warper=args.use_warper,
        warp_size=tuple(args.warp_size), warp_with_nearest=warp_with_nearest)
    model = Reconstructor(cfg, dtype=dtype)
    if load is None:
        init_weights(model, torch.Generator().manual_seed(seed))
    elif load.endswith(".pth"):
        state = torch.load(load, map_location="cpu", weights_only=True)
        model.load_state_dict(state, strict=True)
    else:
        raise NotImplementedError(
            f"{load}: only reference-keyed .pth checkpoints load so far; "
            ".msgpack/orbax import is ROADMAP.md queue 1 step 6 (export one "
            "with the JAX package's save_torch_checkpoint)")
    if fold_bn:
        fold_batchnorm(model)
    model = model.to(device).eval()

    labels = open_court_template(resolve_asset(args.court_img),
                                 num_classes=args.mask_classes,
                                 size=args.court_size)
    court_poi = load_court_poi(resolve_asset(args.court_poi)).astype(np.float32)
    return ModelBundle(model, torch.from_numpy(labels).to(device),
                       template_value_table(labels, args.mask_classes).to(device),
                       court_poi, cfg, device)


def discover_conf(load_path: Optional[str], conf_path: Optional[str]):
    """Sidecar ``conf.yaml`` next to the checkpoint."""
    if conf_path is None and load_path is not None:
        conf_path = os.path.join(os.path.dirname(load_path), "conf.yaml")
    if conf_path is not None and not os.path.isfile(conf_path):
        conf_path = None
    return conf_path
