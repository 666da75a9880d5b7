"""Training: the multi-loss objective, one optimizer step, the epoch loop
(port of ``train/loop.py``: ``LossConfig``, ``make_loss_fn``,
``make_train_step`` with ``grad_accum=1`` and no mesh axis, ``train_net``).

One step: forward in training mode (batch-stat BatchNorm, running stats
updated), the enabled losses, ``backward()`` through the DoubleConv and
deconv autograd Functions, gradient value clipping at 0.1, then the torch
optimizer's step (weight decay coupled into the gradient).  The
consistency loss's warmup gate is a multiplier, as in the JAX step.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import torch

from ..models.losses import (cross_entropy_map, focal_loss_map, mse_map,
                             per_sample_weighted, reprojection_loss,
                             smooth_l1_map)
from ..utils.checkpoint import save_checkpoint
from .evaluate import eval_reconstructor, norm_img
from .optim import clip_gradients, make_optimizer, make_scheduler

__all__ = ["LossConfig", "consistency_labels", "compute_losses", "train_step",
           "train_net"]


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss selection and lambdas (the JAX ``LossConfig``)."""

    seg_loss: Optional[str] = "CE"          # CE | focal | None
    rec_loss: Optional[str] = "MSE"         # MSE | SmoothL1 | None
    reproj_loss: Optional[str] = None       # RRMSE | None
    consist_loss: Optional[str] = None      # CE | focal | None
    seg_lambda: float = 2.0
    rec_lambda: float = 2.0
    reproj_lambda: float = 8.0
    consist_lambda: float = 1.0
    consist_start_iter: int = 0
    batch_size: int = 8
    # "ref": the reference's per-sample weighting, whose (B,) * (B, 1)
    # broadcast makes the seg and rec losses mean(loss) * mean(weights);
    # "sample": mean(w_i * l_i)
    weight_semantics: str = "ref"


def _class_map(name):
    return cross_entropy_map if name == "CE" else focal_loss_map


def consistency_labels(warp_mask: torch.Tensor, num_classes: int) -> torch.Tensor:
    """The consistency loss's targets, ``trunc(warp_mask * classes)``.

    Inside a class region the bilinear warp's value sits within an ulp of
    ``k / classes``, so a label there follows the last bit of the warp and
    two runs whose theta differs by rounding disagree on some of them."""
    return (warp_mask * num_classes).to(torch.int32)


def compute_losses(preds: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                   step_no: int, cfg: LossConfig, num_classes: int,
                   consist_labels: Optional[torch.Tensor] = None):
    """The JAX ``make_loss_fn`` objective on a batch without padding.

    ``consist_labels`` replaces ``consistency_labels(preds["warp_mask"])``
    as the consistency loss's targets (to hold two runs to the same
    labels).  Returns (total f32 scalar, logs): logs hold the detached
    per-loss values under the JAX names (Seg_loss, Rec_loss, Reproj_loss,
    Cons_loss, Tot_loss).
    """
    logs = {}
    total = torch.zeros((), dtype=torch.float32, device=batch["mask"].device)
    w_raw = batch["weight"].reshape(-1).float()
    if cfg.weight_semantics == "ref":
        wbar, seg_rec_w = w_raw.mean(), torch.ones_like(w_raw)
    else:
        wbar, seg_rec_w = 1.0, w_raw

    if cfg.seg_loss is not None:
        m = _class_map(cfg.seg_loss)(preds["logits"], batch["mask"])
        seg = per_sample_weighted(m, seg_rec_w) * wbar * cfg.seg_lambda
        total = total + seg
        logs["Seg_loss"] = seg
    if cfg.rec_loss is not None:
        gt_f = batch["mask"].float() / float(num_classes)
        fn = {"MSE": mse_map, "SmoothL1": smooth_l1_map}[cfg.rec_loss]
        rec = per_sample_weighted(fn(preds["warp_mask"], gt_f), seg_rec_w) \
            * wbar * cfg.rec_lambda
        total = total + rec
        logs["Rec_loss"] = rec
    if cfg.reproj_loss is not None:
        rl = reprojection_loss(preds["poi"], batch["poi"].float(),
                               batch["nonzeros"].float(),
                               batch["num_nonzero"].float(), "none")
        rl = rl.mean() * cfg.reproj_lambda
        total = total + rl
        logs["Reproj_loss"] = rl
    if cfg.consist_loss is not None:
        labels = (consist_labels if consist_labels is not None
                  else consistency_labels(preds["warp_mask"], num_classes))
        m = _class_map(cfg.consist_loss)(preds["logits"], labels)
        # warmup gate (reference train.py:219-220), a multiplier as in JAX
        gate = float(step_no * cfg.batch_size >= cfg.consist_start_iter)
        cl = m.mean() * cfg.consist_lambda * gate
        total = total + cl
        logs["Cons_loss"] = cl
    logs["Tot_loss"] = total
    return total, {k: v.detach() for k, v in logs.items()}


def train_step(model, optimizer, batch: Dict[str, torch.Tensor], step_no: int,
               court_template: torch.Tensor, court_poi: torch.Tensor,
               cfg: LossConfig, return_grads: bool = False):
    """One optimizer step on a device batch (uint8 ``image``).

    Returns the logs (detached device scalars) and, with ``return_grads``,
    the parameter gradients before clipping, by parameter name.
    """
    model.train()
    preds = model(norm_img(batch["image"]), court_template, court_poi)
    total, logs = compute_losses(preds, batch, step_no, cfg,
                                 model.config.mask_classes)
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    grads = None
    if return_grads:
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
    clip_gradients(model.parameters())
    optimizer.step()
    return (logs, grads) if return_grads else logs


def train_net(model, court_template, court_poi, train_loader, n_train,
              val_loader, batch_size, val_step_n, loss_cfg: LossConfig,
              device, opt="RMSprop", epochs=5, lr=1e-4, w_decay=1e-8,
              target_size=(1280, 720), cp_dir=None, logger=None):
    """Host-side training orchestration (the JAX ``train_net`` on one
    device, without TensorBoard, resume, interrupt saves or gradient
    accumulation).

    ``train_loader`` / ``val_loader`` yield host batches, copied to
    ``device`` ahead of use (``device_prefetch``).  Validation runs every
    ``val_step_n`` optimizer steps and steps the plateau scheduler on its
    reprojection error in pixels; each epoch ends with ``CP_epoch{n}.pth``
    in ``cp_dir``.

    Returns ``{"steps": [per-step logs as floats, with "seconds" on the
    host clock from the end of the previous step, loader wait included],
    "validations": [results]}``.
    """
    import logging

    from ..data.loader import device_prefetch

    logger = logger or logging
    val_step_n = val_step_n if val_step_n is not None else int(n_train / batch_size) + 1
    optimizer = make_optimizer(opt, model.parameters(), lr, w_decay)
    scheduler = make_scheduler(optimizer)
    logger.info(f"""# Starting training:
            Optimizer:       {opt}
            Epochs:          {epochs}
            Val step:        {val_step_n}
            Batch size:      {batch_size}
            Learning rate:   {lr}
            Weight decay:    {w_decay}
            Losses:          seg={loss_cfg.seg_loss} rec={loss_cfg.rec_loss} \
reproj={loss_cfg.reproj_loss} consist={loss_cfg.consist_loss}
            Lambdas:         seg={loss_cfg.seg_lambda} rec={loss_cfg.rec_lambda} \
reproj={loss_cfg.reproj_lambda} consist={loss_cfg.consist_lambda}
            Cons start iter: {loss_cfg.consist_start_iter}
            Checkpoints dir: {cp_dir}
            Device:          {device}
    """)
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    history = {"steps": [], "validations": []}
    global_step = 0
    for epoch in range(epochs):
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        epoch_loss, t_epoch = 0.0, time.perf_counter()
        t0 = time.perf_counter()
        for batch in device_prefetch(train_loader, device):
            logs = train_step(model, optimizer, batch, global_step,
                              court_template, court_poi, loss_cfg)
            logs = {k: float(v) for k, v in logs.items()}
            sync()
            logs["seconds"] = time.perf_counter() - t0
            history["steps"].append(logs)
            t0 = time.perf_counter()
            global_step += 1
            epoch_loss += logs["Tot_loss"]
            logger.info("step {}: {}".format(global_step, ", ".join(
                f"{k} {v:.5f}" for k, v in logs.items())))
            if global_step % val_step_n == 0 and val_loader is not None:
                result = eval_reconstructor(
                    model, device_prefetch(val_loader, device),
                    court_template, court_poi, target_size,
                    loss_cfg.weight_semantics)
                history["validations"].append(result)
                scheduler.step(result["val_reproj_px"])
                val_tot = (result["val_seg_score"] + result["val_rec_score"]
                           + result["val_reproj_score"] + result["val_consist_score"])
                logger.info(
                    "[Validation, epoch: {} of {}, step: {}] Tot: {}, seg: {}, "
                    "rec: {}, reproj: {}({:.3f})px, cons: {}, lr: {}".format(
                        epoch + 1, epochs, global_step, val_tot,
                        result["val_seg_score"], result["val_rec_score"],
                        result["val_reproj_score"], result["val_reproj_px"],
                        result["val_consist_score"],
                        optimizer.param_groups[0]["lr"]))
        logger.info("Epoch {} done in {:.1f}s, loss {:.4f}".format(
            epoch + 1, time.perf_counter() - t_epoch, epoch_loss))
        if cp_dir is not None:
            path = os.path.join(cp_dir, f"CP_epoch{epoch + 1}.pth")
            save_checkpoint(path, model)
            logger.info(f"Checkpoint {epoch + 1} saved !")
    return history
