"""Model construction for the CLIs (port of ``cli/engine.py``): build the
Reconstructor from parsed arguments, load its weights, fold BN, and load
the court constants onto the device; ``predict_fn`` is the predict CLI's
device program (the JAX ``jit_predict_fn``, run eagerly).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..compat.flax_msgpack import load_msgpack
from ..compat.jax_params import state_dict_from_jax
from ..data.assets import open_court_template
from ..geometry.court import load_court_poi
from ..models import Reconstructor, ReconstructorConfig
from ..models.layers import init_weights
from ..ops.fold_bn import fold_batchnorm
from ..ops.warp import template_value_table
from ..utils.config import resolve_asset

__all__ = ["ModelBundle", "build_model", "check_loadable", "load_state_dict", "predict_fn",
           "discover_conf", "dtype_from_str"]


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


def check_loadable(load: Optional[str]) -> None:
    """Refuse weights other than a reference-keyed ``.pth`` or the JAX
    package's ``.msgpack``."""
    if load is not None and not load.endswith((".pth", ".msgpack")):
        raise NotImplementedError(
            f"{load}: only reference-keyed .pth and the JAX package's .msgpack "
            "checkpoints load; convert an orbax directory with the JAX package's "
            "scripts/export_torch_checkpoint.py")


def load_state_dict(load: str) -> Dict[str, torch.Tensor]:
    """The reference-keyed ``state_dict`` of a ``.pth``, or of a ``.msgpack``
    that the JAX package wrote (its ``{"params", "batch_stats"}`` tree)."""
    check_loadable(load)
    if load.endswith(".msgpack"):
        return state_dict_from_jax(load_msgpack(load))
    return torch.load(load, map_location="cpu", weights_only=True)


def build_model(args, load: Optional[str] = None, seed: int = 0,
                fold_bn: bool = False, warp_with_nearest: bool = False) -> ModelBundle:
    """Construct the Reconstructor and court constants from parsed args.

    ``load``: a reference-keyed ``.pth`` state_dict (the JAX package's
    ``save_torch_checkpoint`` writes these) or a JAX ``.msgpack``
    (``load_state_dict``), loaded with ``strict=True``; None initialises
    from ``seed`` with a ``torch.Generator``.
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
    check_loadable(load)
    model = Reconstructor(cfg, dtype=dtype)
    if load is None:
        init_weights(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(load_state_dict(load), strict=True)
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


def predict_fn(bundle: ModelBundle, consistency: bool,
               keep: Iterable[str]) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """The predict CLI's device program: uint8 frames in, the ``keep``
    outputs out, all on the model's device.

    It divides the (B, H, W, 3) uint8 frames by 255 (true division:
    ``x * (1 / 255)`` differs in the last ulp), runs ``Reconstructor.predict``
    (K1 on the full warp grid when ``warp_mask`` is kept, else on the
    logits grid for the score alone; ``poi`` when it is kept), narrows the
    argmax of the logits (``segm_mask``) and the warp labels to uint8, and
    drops what ``keep`` does not name, so only those outputs need copying
    to the host.
    """
    keep = frozenset(keep)
    court_poi = (torch.from_numpy(bundle.court_poi).to(bundle.device)
                 if "poi" in keep else None)

    def fn(frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        preds = bundle.model.predict(frames.float() / 255.0, bundle.court_labels,
                                     bundle.value_table, consistency=consistency,
                                     warp_mask="warp_mask" in keep, court_poi=court_poi)
        if "segm_mask" in keep and "logits" in preds:
            preds["segm_mask"] = preds["logits"].argmax(dim=-1).to(torch.uint8)
        if "warp_mask" in preds:
            preds["warp_mask"] = preds["warp_mask"].to(torch.uint8)
        return {k: v for k, v in preds.items() if k in keep}

    return fn


def discover_conf(load_path: Optional[str], conf_path: Optional[str]):
    """Sidecar ``conf.yaml`` next to the checkpoint."""
    if conf_path is None and load_path is not None:
        conf_path = os.path.join(os.path.dirname(load_path), "conf.yaml")
    if conf_path is not None and not os.path.isfile(conf_path):
        conf_path = None
    return conf_path
