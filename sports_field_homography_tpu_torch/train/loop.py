"""Training: the multi-loss objective, one optimizer step, the epoch loop
(port of ``train/loop.py``: ``LossConfig``, ``make_loss_fn``,
``make_train_step`` on one device, ``_accumulation_groups``,
``train_net`` and ``_tb_images``).

One step: forward in training mode (batch-stat BatchNorm, running stats
updated), the enabled losses, ``backward()`` through the DoubleConv and
deconv autograd Functions, gradient value clipping at 0.1, then the torch
optimizer's step (weight decay coupled into the gradient).  The
consistency loss's warmup gate is a multiplier, as in the JAX step.

The last batch of an epoch is the true smaller one: the JAX package's
masked program on a padded tail (loss means and BatchNorm moments over the
valid rows only) computes exactly this step on its real rows, so the port
pads nothing, and that step runs on the same kernels.  With gradient
accumulation a step takes K micro-batches, runs K backward passes into the
same ``.grad`` (running stats threaded through them in order), divides by
K, then clips and steps once.

Data parallel (``replicas``, a ``parallel/distributed.Replicas``; the JAX
``make_train_step(axis_name="data")`` under ``shard_train_step``): each
rank runs its slice of every (micro-)batch with BatchNorm over the global
batch (``models/layers.set_bn_sync``), scales its losses by ``B_local *
ranks / B_global`` (the global counts all-reduced first, so a ragged tail
split 3 + 2 gives the global means), and after the last micro-batch one
flat all-reduce averages the gradients, the logs and a stop flag
(``parallel/mesh.average_gradients``); every rank then clips and steps
alike.  Only rank 0 writes checkpoints and TensorBoard; every rank runs
the validation, and rank 0's metrics step every rank's scheduler.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..models.losses import (cross_entropy_map, focal_loss_map, mse_map,
                             per_sample_weighted, reprojection_loss,
                             smooth_l1_map)
from ..parallel.mesh import average_gradients
from ..utils.checkpoint import AsyncSaver, load_train_state, save_checkpoint
from .evaluate import eval_reconstructor, norm_img
from .optim import clip_gradients, make_optimizer, make_scheduler

__all__ = ["LossConfig", "consistency_labels", "compute_losses", "train_step",
           "train_net"]

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss selection and lambdas (the JAX ``LossConfig``)."""

    seg_loss: Optional[str] = "CE"          # CE | focal | None
    rec_loss: Optional[str] = "MSE"         # MSE | SmoothL1 | None
    reproj_loss: Optional[str] = None       # RRMSE | None
    consist_loss: Optional[str] = None      # CE | focal | None
    uv_loss: Optional[str] = None           # MSE | SmoothL1 | None
    seg_lambda: float = 2.0
    rec_lambda: float = 2.0
    reproj_lambda: float = 8.0
    consist_lambda: float = 1.0
    uv_lambda: float = 2.0
    consist_start_iter: int = 0
    batch_size: int = 8
    # "ref": the reference's per-sample weighting, whose (B,) * (B, 1)
    # broadcast makes the seg and rec losses mean(loss) * mean(weights)
    # (the UV loss stays truly per-sample); "sample": mean(w_i * l_i)
    weight_semantics: str = "ref"


# the JAX train_net's TensorBoard names of the step's logs
TB_TRAIN_TAGS = {"Seg_loss": "Loss/train seg", "Rec_loss": "Loss/train rec",
                 "UV_loss": "Loss/train uv", "Reproj_loss": "Loss/train reproj",
                 "Cons_loss": "Loss/train consistency", "Tot_loss": "Loss/train"}


def _class_map(name):
    return cross_entropy_map if name == "CE" else focal_loss_map


def _elementwise(name):
    return {"MSE": mse_map, "SmoothL1": smooth_l1_map}[name]


def consistency_labels(warp_mask: torch.Tensor, num_classes: int) -> torch.Tensor:
    """The consistency loss's targets, ``trunc(warp_mask * classes)``.

    Inside a class region the bilinear warp's value sits within an ulp of
    ``k / classes``, so a label there follows the last bit of the warp and
    two runs whose theta differs by rounding disagree on some of them."""
    return (warp_mask * num_classes).to(torch.int32)


def compute_losses(preds: Dict[str, torch.Tensor], batch: Batch, step_no: int,
                   cfg: LossConfig, num_classes: int,
                   consist_labels: Optional[torch.Tensor] = None, shard=None):
    """The JAX ``make_loss_fn`` objective on one device, on a batch of
    real samples (no ``valid`` mask).  The UV loss runs when
    ``cfg.uv_loss`` is set and the model returned ``uv``.
    ``consist_labels`` replaces ``consistency_labels(preds["warp_mask"])``
    as the consistency loss's targets (to hold two runs to the same
    labels).  ``shard``: ``(scale, global weight sum / B_global)`` on a
    data-parallel rank (``train_step``); every term is scaled so that the
    ranks' mean is the global batch's loss (the JAX ``scale`` and
    ``wbar``).  Returns (total f32 scalar, logs): logs hold the detached
    per-loss values under the JAX names (Seg_loss, Rec_loss, UV_loss,
    Reproj_loss, Cons_loss, Tot_loss).
    """
    logs = {}
    w_raw = batch["weight"].reshape(-1).float()
    total = torch.zeros((), dtype=torch.float32, device=w_raw.device)
    scale = 1.0 if shard is None else shard[0]
    if cfg.weight_semantics == "ref":
        wbar = w_raw.mean() if shard is None else shard[1]
        seg_rec_w = torch.ones_like(w_raw) * scale
    else:
        wbar, seg_rec_w = 1.0, w_raw * scale

    if cfg.seg_loss is not None:
        m = _class_map(cfg.seg_loss)(preds["logits"], batch["mask"])
        seg = per_sample_weighted(m, seg_rec_w) * wbar * cfg.seg_lambda
        total = total + seg
        logs["Seg_loss"] = seg
    if cfg.rec_loss is not None:
        gt_f = batch["mask"].float() / float(num_classes)
        rec = per_sample_weighted(_elementwise(cfg.rec_loss)(preds["warp_mask"], gt_f),
                                  seg_rec_w) * wbar * cfg.rec_lambda
        total = total + rec
        logs["Rec_loss"] = rec
    if cfg.uv_loss is not None and "uv" in preds:
        # truly per-sample in the reference too: its NCHW map broadcasts aligned
        uvl = per_sample_weighted(_elementwise(cfg.uv_loss)(preds["uv"], batch["uv"]),
                                  w_raw * scale) * cfg.uv_lambda
        total = total + uvl
        logs["UV_loss"] = uvl
    if cfg.reproj_loss is not None:
        rl = reprojection_loss(preds["poi"], batch["poi"].float(),
                               batch["nonzeros"].float(),
                               batch["num_nonzero"].float(), "none")
        rl = rl.mean() * scale * cfg.reproj_lambda
        total = total + rl
        logs["Reproj_loss"] = rl
    if cfg.consist_loss is not None:
        labels = (consist_labels if consist_labels is not None
                  else consistency_labels(preds["warp_mask"], num_classes))
        m = _class_map(cfg.consist_loss)(preds["logits"], labels)
        # warmup gate (reference train.py:219-220), a multiplier as in JAX
        gate = float(step_no * cfg.batch_size >= cfg.consist_start_iter)
        cl = m.mean() * scale * cfg.consist_lambda * gate
        total = total + cl
        logs["Cons_loss"] = cl
    logs["Tot_loss"] = total
    return total, {k: v.detach() for k, v in logs.items()}


def train_step(model, optimizer, batch: Union[Batch, List[Batch]], step_no: int,
               court_template: torch.Tensor, court_poi: torch.Tensor,
               cfg: LossConfig, return_grads: bool = False, replicas=None,
               stop: bool = False):
    """One optimizer step on a device batch (uint8 or float ``image``), or
    on a list of K micro-batches (gradient accumulation: K backward passes,
    the gradients' mean, one clip and one optimizer step; the logs are the
    K micro-batches' mean).

    ``replicas`` (data parallel): ``batch`` is this rank's slice; each
    micro-batch first all-reduces its size and weight sum, BatchNorm runs
    over the global batch (the model's ``bn_sync``), and one all-reduce
    averages the gradients and the logs, and ORs ``stop`` (this rank's
    interrupt flag) into ``logs["stop"]``: every rank reads the same
    verdict.

    Returns the logs (detached device scalars) and, with ``return_grads``,
    the parameter gradients before clipping (averaged over the ranks), by
    parameter name.
    """
    micro = list(batch) if isinstance(batch, (list, tuple)) else [batch]
    model.train()
    optimizer.zero_grad(set_to_none=True)
    logs = None
    for mb in micro:
        shard = None
        if replicas is not None:
            n_local = int(mb["image"].shape[0])
            w_sum = mb["weight"].reshape(-1).float().sum()
            n_total, w_total = replicas.set_batch(n_local, w_sum)
            shard = (n_local * replicas.world / n_total, w_total / n_total)
        preds = model(norm_img(mb["image"]), court_template, court_poi)
        total, lg = compute_losses(preds, mb, step_no, cfg, model.config.mask_classes,
                                   shard=shard)
        total.backward()
        logs = lg if logs is None else {k: logs[k] + v for k, v in lg.items()}
    if len(micro) > 1:
        k = len(micro)
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(k)
        logs = {name: v / k for name, v in logs.items()}
    if replicas is not None:
        names = list(logs)
        *summed, votes = average_gradients(
            model.parameters(), replicas, [logs[n] for n in names] + [float(stop)])
        logs = {n: v / replicas.world for n, v in zip(names, summed)}
        logs["stop"] = votes > 0
    grads = None
    if return_grads:
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
    clip_gradients(model.parameters())
    optimizer.step()
    return (logs, grads) if return_grads else logs


def _accumulation_groups(batches, k: int, on_partial):
    """Every ``k`` consecutive batches as one list; a tail group smaller
    than ``k`` is dropped (it would change its step's effective batch) and
    its size passed to ``on_partial``."""
    group = []
    for batch in batches:
        group.append(batch)
        if len(group) == k:
            yield group
            group = []
    if group:
        on_partial(len(group))


def _summary_writer(log_dir, logger):
    """A ``torch.utils.tensorboard.SummaryWriter`` at ``log_dir``, or None
    (logged) where tensorboard does not import."""
    if log_dir is None:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:
        logger.info("tensorboard unavailable; TB logging disabled")
        return None
    return SummaryWriter(log_dir=log_dir)


def _tb_images(writer, result, num_classes, global_step):
    """The validation image panel (reference ``train.py:282-312``): the
    last batch's frames, predicted masks, warped court and UV, NCHW."""
    from ..utils.postprocess import onehot_to_image, preds_to_masks

    output = [np.transpose(result["imgs"], (0, 3, 1, 2))]
    if "logits" in result:
        pred = onehot_to_image(preds_to_masks(result["logits"], num_classes),
                               num_classes)[..., ::-1]
        output.append(np.transpose(pred, (0, 3, 1, 2)).astype(np.float32) / 255.0)
    if "warp_masks" in result:
        warp = onehot_to_image((result["warp_masks"] * num_classes).astype(np.uint8),
                               num_classes)[..., ::-1]
        output.append(np.transpose(warp, (0, 3, 1, 2)).astype(np.float32) / 255.0)
    if "uv_masks" in result:
        uvm = np.transpose(result["uv_masks"], (0, 3, 1, 2)).astype(np.float32)
        z = np.zeros((uvm.shape[0], 1, uvm.shape[-2], uvm.shape[-1]), np.float32)
        output.append(np.concatenate((uvm, z), axis=1))
    writer.add_images("output", np.concatenate(output, axis=2), global_step)


def train_net(model, court_template, court_poi, train_loader, n_train,
              val_loader, batch_size, val_step_n, loss_cfg: LossConfig,
              device, opt="RMSprop", epochs=5, lr=1e-4, w_decay=1e-8,
              target_size=(1280, 720), cp_dir=None, logger=None, log_dir=None,
              vizualize=False, state_holder=None, resume_state_path=None,
              async_ckpt=False, grad_accum=1, resume_sched=None, replicas=None):
    """Host-side training orchestration (the JAX ``train_net`` on one
    device).

    ``train_loader`` / ``val_loader`` yield host batches, copied to
    ``device`` ahead of use (``device_prefetch``).  Validation runs every
    ``val_step_n`` optimizer steps and steps the plateau scheduler on its
    reprojection error in pixels; each epoch ends with ``CP_epoch{n}.pth``
    in ``cp_dir``, written on a background thread with ``async_ckpt``.

    ``grad_accum=K``: K loader batches per optimizer step (``train_step``);
    ``val_step_n`` counts optimizer steps.  ``log_dir``: TensorBoard
    scalars under the JAX names, and on validation steps histograms of the
    weights and of that step's own gradients (``vizualize``: the image
    panel too).  ``state_holder``: a dict the train CLI's signal handler
    reads; after every step it holds ``state`` (the live model, optimizer,
    scheduler and counters) and ``sched`` (the data-schedule position), and
    when the handler has set ``interrupt`` the loop calls ``save_and_exit``
    at the next point between steps.  ``resume_state_path``: a
    ``last_state.pth`` to start from; ``resume_sched`` (``{"epoch": e,
    "opt_steps_done": k}``) replays epoch e's order from its ``(seed,
    epoch)`` and skips its first k optimizer steps' batches unread, so an
    interrupted and resumed run finishes the original plan exactly as an
    uninterrupted one.

    ``replicas`` (data parallel): ``train_loader`` yields this rank's
    slices of the global batches (``batch_size`` is the global size) and
    the model's BatchNorm is synced (``models/layers.set_bn_sync``).  The
    interrupt is agreed on by every rank (any rank's flag stops all, after
    the same step); rank 0 alone writes TensorBoard and checkpoints; every
    rank validates and steps its scheduler on rank 0's metrics; a resume
    reads ``resume_state_path`` after a barrier.

    Returns ``{"steps": [per-step logs as floats, with "seconds" on the
    host clock from the end of the previous step and "wait", the part of
    it spent waiting for the next batch], "validations": [results]}``.
    """
    import logging

    from ..data.loader import device_prefetch

    logger = logger or logging
    val_step_n = val_step_n if val_step_n is not None else int(n_train / batch_size) + 1
    logger.info(f"""# Starting training:
            Optimizer:       {opt}
            Epochs:          {epochs}
            Val step:        {val_step_n}
            Batch size:      {batch_size}
            Learning rate:   {lr}
            Weight decay:    {w_decay}
            Losses:          seg={loss_cfg.seg_loss} rec={loss_cfg.rec_loss} \
reproj={loss_cfg.reproj_loss} consist={loss_cfg.consist_loss} uv={loss_cfg.uv_loss}
            Lambdas:         seg={loss_cfg.seg_lambda} rec={loss_cfg.rec_lambda} \
reproj={loss_cfg.reproj_lambda} consist={loss_cfg.consist_lambda} uv={loss_cfg.uv_lambda}
            Cons start iter: {loss_cfg.consist_start_iter}
            Checkpoints dir: {cp_dir}
            Log dir:         {log_dir}
            Device:          {device}
    """)
    main = replicas is None or replicas.is_main
    writer = _summary_writer(log_dir, logger) if main else None
    optimizer = make_optimizer(opt, model.parameters(), lr, w_decay)
    scheduler = make_scheduler(optimizer)
    global_step = 0
    if replicas is not None:
        replicas.barrier()            # rank 0's files are complete before anyone reads
    if resume_state_path is not None and os.path.exists(resume_state_path):
        global_step = load_train_state(resume_state_path, model, optimizer, scheduler)["step"]
        logger.info(f"Resumed full train state from {resume_state_path} (step {global_step})")
    history = {"steps": [], "validations": []}
    saver = AsyncSaver() if async_ckpt and main else None

    def interrupted() -> bool:
        return state_holder is not None and bool(state_holder.get("interrupt"))

    def interrupt_check(agreed=None):
        # the signal handler only sets a flag; the save happens here, where
        # no step is half done.  Data parallel: the ranks' flags are ORed
        # (in the step's all-reduce, ``agreed``, or here), so all stop at once
        stop = interrupted() if replicas is None else (
            replicas.any(interrupted()) if agreed is None else agreed)
        if stop:
            if saver is not None:
                saver.wait()          # flush pending epoch checkpoints
            state_holder["save_and_exit"]()

    def validate(epoch, step, grads):
        """TensorBoard histograms first (the weights, and ``grads``, the
        gradients of the step just taken), then the metrics, the plateau
        scheduler's step and their logs."""
        if writer is not None:
            for name, p in model.named_parameters():
                writer.add_histogram("weights/" + name, p.detach().float().cpu().numpy(), step)
            for name, g in (grads or {}).items():
                writer.add_histogram("grads/" + name, g.float().cpu().numpy(), step)
        images = vizualize and writer is not None
        result = eval_reconstructor(model, device_prefetch(val_loader, device),
                                    court_template, court_poi, target_size,
                                    loss_cfg.weight_semantics, keep_last=images)
        if replicas is not None:      # rank 0's metrics on every rank
            keys = sorted(k for k, v in result.items() if not isinstance(v, np.ndarray))
            t = torch.tensor([float(result[k]) for k in keys], dtype=torch.float64,
                             device=replicas.device)
            replicas.broadcast_(t, 0)
            result.update(zip(keys, t.tolist()))
        history["validations"].append({k: v for k, v in result.items()
                                       if not isinstance(v, np.ndarray)})
        lr_before = optimizer.param_groups[0]["lr"]
        scheduler.step(result["val_reproj_px"])
        new_lr = optimizer.param_groups[0]["lr"]
        if new_lr != lr_before:
            logger.info("Learning rate has been changed: {}".format(new_lr))
        val_tot = (result["val_seg_score"] + result["val_rec_score"]
                   + result["val_reproj_score"] + result["val_consist_score"]
                   + result["val_uv_score"])
        if writer is not None:
            for tag, value in (("learning_rate", new_lr), ("Loss/test", val_tot),
                               ("Loss/test_seg", result["val_seg_score"]),
                               ("Loss/test_rec", result["val_rec_score"]),
                               ("Loss/test_uv", result["val_uv_score"]),
                               ("Loss/test_reproj", result["val_reproj_px"]),
                               ("Loss/test_consist", result["val_consist_score"])):
                writer.add_scalar(tag, value, step)
        logger.info(
            "[Validation, epoch: {} of {}, step: {}] Tot: {}, seg: {}, rec: {}, uv: {}, "
            "reproj: {}({:.3f})px, cons: {}, lr: {}".format(
                epoch + 1, epochs, step, val_tot, result["val_seg_score"],
                result["val_rec_score"], result["val_uv_score"], result["val_reproj_score"],
                result["val_reproj_px"], result["val_consist_score"], new_lr))
        if images:
            _tb_images(writer, result, model.config.mask_classes, step)

    # exact mid-epoch resume: position the epoch loop and the data schedule
    batches_per_epoch = max(1, -(-n_train // batch_size))
    opt_steps_per_epoch = (batches_per_epoch // grad_accum if grad_accum > 1
                           else batches_per_epoch)
    start_epoch, resume_skip = 0, 0
    if resume_sched:
        start_epoch = int(resume_sched.get("epoch", 0))
        resume_skip = int(resume_sched.get("opt_steps_done", 0))
        if resume_skip >= opt_steps_per_epoch:   # stopped at an epoch boundary
            start_epoch, resume_skip = start_epoch + 1, 0
        if start_epoch >= epochs:
            logger.info(f"Resumed run already finished its {epochs} epochs; nothing "
                        "to do (raise --epochs to train further)")
        else:
            logger.info(f"Exact resume: epoch {start_epoch + 1}, skipping "
                        f"{resume_skip} consumed optimizer steps")

    try:
        for epoch in range(start_epoch, epochs):
            train_loader.set_epoch(epoch)
            skip_now = resume_skip if epoch == start_epoch else 0
            if skip_now:
                train_loader.skip_next_batches(skip_now * grad_accum)
            steps_in_epoch, epoch_loss, t_epoch = skip_now, 0.0, time.perf_counter()
            batches = device_prefetch(train_loader, device)
            if grad_accum > 1:
                batches = _accumulation_groups(
                    batches, grad_accum, lambda n, e=epoch: logger.info(
                        f"Gradient accumulation: dropped the last {n} batch(es) of "
                        f"epoch {e + 1}, fewer than {grad_accum}"))
            it = iter(batches)
            t0 = time.perf_counter()
            while True:
                batch = next(it, None)
                if batch is None:
                    break
                wait = time.perf_counter() - t0
                want_grads = (writer is not None and val_loader is not None
                              and (global_step + 1) % val_step_n == 0)
                logs = train_step(model, optimizer, batch, global_step, court_template,
                                  court_poi, loss_cfg, return_grads=want_grads,
                                  replicas=replicas, stop=interrupted())
                logs, grads = logs if want_grads else (logs, None)
                agreed = bool(logs.pop("stop")) if replicas is not None else None
                logs = {k: float(v) for k, v in logs.items()}
                global_step += 1
                steps_in_epoch += 1
                logs["seconds"], logs["wait"] = time.perf_counter() - t0, wait
                history["steps"].append(logs)
                if state_holder is not None:
                    state_holder["state"] = {
                        "model": model, "optimizer": optimizer, "scheduler": scheduler,
                        "step": global_step, "epoch": epoch,
                        "opt_steps_done": steps_in_epoch}
                    state_holder["sched"] = {"epoch": epoch, "opt_steps_done": steps_in_epoch}
                interrupt_check(agreed)
                epoch_loss += logs["Tot_loss"]
                logger.info("step {}: {}".format(global_step, ", ".join(
                    f"{k} {v:.5f}" for k, v in logs.items())))
                if writer is not None:
                    for k, tag in TB_TRAIN_TAGS.items():
                        if k in logs:
                            writer.add_scalar(tag, logs[k], global_step)
                if global_step % val_step_n == 0 and val_loader is not None:
                    validate(epoch, global_step, grads)
                    interrupt_check()      # a signal may land during validation
                t0 = time.perf_counter()
            logger.info("Epoch {} done in {:.1f}s, loss {:.4f}".format(
                epoch + 1, time.perf_counter() - t_epoch, epoch_loss))
            if cp_dir is not None and main:
                path = os.path.join(cp_dir, f"CP_epoch{epoch + 1}.pth")
                if saver is not None:
                    saver.save(path, model.state_dict())
                    logger.info(f"Checkpoint {epoch + 1} saving (async)...")
                else:
                    save_checkpoint(path, model)
                    logger.info(f"Checkpoint {epoch + 1} saved !")
            interrupt_check()              # a signal during the epoch-end save
    finally:
        if saver is not None:
            saver.close()
            logger.info("Async checkpoints flushed.")
        if writer is not None:
            writer.close()
    return history
