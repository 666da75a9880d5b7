"""The system under test, built as its own entry points build it: the one
module of the harness that imports ``sports_field_homography_tpu_torch``.

The weights come from the harness (``inputs.seeded_state_dict``) and load
with ``strict=True``; what the program derives from them (the folded
BatchNorm, the court's value table) it derives itself.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_kernels", "predict_bundle", "predict_program", "to_host",
           "train_program", "start_spans", "stop_spans", "PACKAGE"]

PACKAGE = "sports_field_homography_tpu_torch"


def load_kernels():
    """Build (a checkout's first run) or load the port's CUDA kernels."""
    from sports_field_homography_tpu_torch.ops.build import load_library

    load_library()


def _model(model_cfg: dict, sd: dict, warp_size, train: bool):
    from sports_field_homography_tpu_torch.cli.engine import dtype_from_str
    from sports_field_homography_tpu_torch.models import Reconstructor, ReconstructorConfig

    cfg = ReconstructorConfig(
        target_size=tuple(model_cfg["target_size"]), mask_classes=model_cfg["mask_classes"],
        use_unet=True, unet_bilinear=model_cfg["unet_bilinear"],
        unet_size=tuple(model_cfg["unet_size"]), use_resnet=True,
        resnet_name=model_cfg["resnet_name"], resnet_input=model_cfg["resnet_input"],
        use_warper=True, warp_size=tuple(warp_size))
    with torch.device("meta"):
        model = Reconstructor(cfg, dtype=dtype_from_str(model_cfg["dtype"]))
    model.load_state_dict(sd, strict=True, assign=True)
    return model.train(train), cfg


def predict_bundle(model_cfg: dict, sd: dict, device, warp_size, court_labels: np.ndarray,
                   court_poi: np.ndarray, fold_bn: bool):
    """The predict CLI's ``ModelBundle``: the model with BN folded, the
    court labels and their value table on the device."""
    from sports_field_homography_tpu_torch.cli.engine import ModelBundle
    from sports_field_homography_tpu_torch.ops.fold_bn import fold_batchnorm
    from sports_field_homography_tpu_torch.ops.warp import template_value_table

    model, cfg = _model(model_cfg, sd, warp_size, False)
    if fold_bn:
        fold_batchnorm(model)
    return ModelBundle(model, torch.as_tensor(court_labels, device=device),
                       template_value_table(court_labels, model_cfg["mask_classes"]).to(device),
                       np.asarray(court_poi, np.float32), cfg, torch.device(device))


def predict_program(bundle, keep):
    """``cli/engine.predict_fn``: uint8 frames on the device -> the kept outputs."""
    from sports_field_homography_tpu_torch.cli.engine import predict_fn

    return predict_fn(bundle, "consist_score" in keep, keep)


def to_host(preds, device):
    """``cli/predict._to_host``: start the copies to pinned host memory;
    returns (host tensors, event)."""
    from sports_field_homography_tpu_torch.cli.predict import _to_host

    return _to_host(preds, torch.device(device))


def train_program(model_cfg: dict, train_cfg: dict, sd: dict, device, batch_size: int):
    """The train CLI's step on the example conf: the model in train mode,
    its optimizer, and ``step(batch, step_no)`` -> the step's logs
    (``train/loop.train_step``)."""
    from sports_field_homography_tpu_torch.train.loop import LossConfig, train_step
    from sports_field_homography_tpu_torch.train.optim import make_optimizer

    model, _ = _model(model_cfg, sd, train_cfg["warp_size"], True)
    opt = make_optimizer(train_cfg["opt"], model.parameters(), train_cfg["lr"],
                         train_cfg["weight_decay"])
    loss_cfg = LossConfig(**{k: train_cfg[k] for k in (
        "seg_loss", "rec_loss", "reproj_loss", "consist_loss", "seg_lambda", "rec_lambda",
        "reproj_lambda", "consist_lambda", "consist_start_iter")}, batch_size=batch_size)
    return model, opt, loss_cfg, train_step


def start_spans():
    """Start recording the program's phase spans (``utils/trace.start``)."""
    from sports_field_homography_tpu_torch.utils import trace

    trace.start()


def stop_spans() -> list:
    """Stop recording; the records ``(name, t0_ns, t1_ns, parent, unit)``,
    on ``perf_counter_ns`` (``utils/trace.stop``)."""
    from sports_field_homography_tpu_torch.utils import trace

    return trace.stop()
