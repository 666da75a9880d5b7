"""Validation metrics for the Reconstructor (port of ``train/evaluate.py``,
``make_eval_step`` and ``eval_reconstructor``).

The model runs in eval mode (running BN statistics) with the same forward
as training: PoI projection and the bilinear warp, or the nearest one for
a model built with ``warp_with_nearest`` (the test CLI), which reads
``court_labels``.  Keys as in the JAX package:
val_seg_score, val_rec_score, val_uv_score, val_reproj_score,
val_reproj_px, val_consist_score.  The validation loaders of this port
yield the true (ragged) tail batch, so every batch mean is over real
samples, which is what the JAX package's ``valid``-masked means compute on
its padded tail.

``eval_net`` and ``eval_stn`` score the legacy models
(``models/legacy.py``) as the JAX package's do.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterable

import torch

from ..models.losses import cross_entropy_map, dice_coeff, mse_map, reprojection_loss

__all__ = ["norm_img", "eval_step", "eval_reconstructor", "eval_net", "eval_stn"]


def norm_img(img: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> float32 in [0, 1] (true division, as the JAX
    package's ``u8 / 255``); float frames pass through."""
    return img.float() / 255.0 if img.dtype == torch.uint8 else img


def _per_sample(loss_map: torch.Tensor) -> torch.Tensor:
    return loss_map.float().mean(dim=tuple(range(1, loss_map.dim())))


@torch.no_grad()
def eval_step(model, batch: Dict[str, torch.Tensor], court_template, court_poi,
              target_size, weight_semantics: str = "ref",
              use_per_sample_weights: bool = True,
              court_labels=None) -> Dict[str, torch.Tensor]:
    """Per-batch metrics (the JAX ``make_eval_step``'s ``_step``): seg and
    rec weighted per sample, UV truly per sample, or, without
    ``use_per_sample_weights`` (the test CLI), plain means over the
    samples."""
    preds = model(norm_img(batch["image"]), court_template, court_poi, court_labels)
    return _metrics(preds, batch, model.config.mask_classes, target_size,
                    weight_semantics, use_per_sample_weights)


def _metrics(preds, batch, nc, target_size, weight_semantics,
             use_per_sample_weights) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    logits, warp = preds.get("logits"), preds.get("warp_mask")
    gt_i = batch["mask"].long()

    def seg_rec(loss_map):
        per = _per_sample(loss_map)
        if not use_per_sample_weights:
            return per.mean()
        w = batch["weight"].reshape(-1).float()
        if weight_semantics == "ref":   # the reference's outer-product quirk
            return per.mean() * w.mean()
        return (per * w).mean()

    if logits is not None:
        out["seg"] = seg_rec(cross_entropy_map(logits, gt_i))
    if warp is not None:
        out["rec"] = seg_rec(mse_map(warp, gt_i.float() / float(nc)))
    if "uv" in preds and "uv" in batch:
        per = _per_sample(mse_map(preds["uv"], batch["uv"]))
        out["uv"] = ((per * batch["weight"].reshape(-1).float()).mean()
                     if use_per_sample_weights else per.mean())
    if logits is not None and warp is not None:
        labels = (warp * nc).to(torch.int32)
        out["consist"] = _per_sample(cross_entropy_map(logits, labels)).mean()
    if "poi" in preds and "poi" in batch:
        gt, nz, nn = (batch[k].float() for k in ("poi", "nonzeros", "num_nonzero"))
        out["reproj_sum"] = reprojection_loss(preds["poi"], gt, nz, nn, "none").sum()
        scale = torch.tensor([float(target_size[0]), float(target_size[1])],
                             device=gt.device)
        out["reproj_px_sum"] = reprojection_loss(preds["poi"] * scale, gt * scale,
                                                 nz, nn, "none").sum()
    return out


def eval_reconstructor(model, batches: Iterable[Dict[str, torch.Tensor]],
                       court_template, court_poi, target_size,
                       weight_semantics: str = "ref",
                       use_per_sample_weights: bool = True,
                       court_labels=None, keep_last: bool = False) -> Dict[str, object]:
    """Validation over device batches (the JAX ``eval_reconstructor``):
    seg/rec/uv/consist are means over batches, reprojection means over
    samples.  ``keep_last`` adds the last batch's frames (``imgs``, NHWC
    f32 in [0, 1]), ``logits``, ``warp_masks`` and ``uv_masks`` as host
    arrays (the TensorBoard image panel).  The model's train/eval mode is
    restored afterwards."""
    was_training = model.training
    model.eval()
    sums = {"seg": 0.0, "rec": 0.0, "uv": 0.0, "consist": 0.0, "reproj_sum": 0.0,
            "reproj_px_sum": 0.0}
    n_batches = n_samples = 0
    last = None
    try:
        for batch in batches:
            with torch.no_grad():
                preds = model(norm_img(batch["image"]), court_template, court_poi,
                              court_labels)
                out = _metrics(preds, batch, model.config.mask_classes, target_size,
                               weight_semantics, use_per_sample_weights)
            for k, v in out.items():
                sums[k] += float(v)
            n_batches += 1
            n_samples += int(batch["image"].shape[0])
            if keep_last:
                last = (batch["image"], preds)
    finally:
        model.train(was_training)
    nb, ns = max(n_batches, 1), max(n_samples, 1)
    result = {"val_seg_score": sums["seg"] / nb,
              "val_rec_score": sums["rec"] / nb,
              "val_uv_score": sums["uv"] / nb,
              "val_reproj_score": sums["reproj_sum"] / ns,
              "val_reproj_px": sums["reproj_px_sum"] / ns,
              "val_consist_score": sums["consist"] / nb}
    if last is not None:
        result["imgs"] = norm_img(last[0]).float().cpu().numpy()
        for key, name in (("logits", "logits"), ("warp_mask", "warp_masks"),
                          ("uv", "uv_masks")):
            if key in last[1]:
                result[name] = last[1][key].float().cpu().numpy()
    return result


@contextlib.contextmanager
def _eval_mode(model):
    """Eval mode without autograd; the model's mode is restored after."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        model.train(was_training)


def _on(model, batch, key) -> torch.Tensor:
    """``batch[key]`` (a tensor or an array) on the model's device."""
    return torch.as_tensor(batch[key]).to(next(model.parameters()).device)


def eval_net(model, batches: Iterable[Dict], n_classes: int,
             court_img=None, court_poi=None) -> Dict[str, float]:
    """Legacy segmentation score of a ``models/legacy.UNet`` over batches:
    the mean over batches of the mean cross entropy (``n_classes`` > 1),
    or of the dice coefficient of ``sigmoid(logits) > 0.5`` against the
    mask (one class).  ``court_img`` and ``court_poi`` are not used (the
    JAX package's signature)."""
    tot, n_val = 0.0, 0
    with _eval_mode(model):
        for batch in batches:
            logits = model(norm_img(_on(model, batch, "image")))
            mask = _on(model, batch, "mask")
            if n_classes > 1:
                tot += float(cross_entropy_map(logits, mask.long()).mean())
            else:
                pred = (torch.sigmoid(logits[..., 0].float()) > 0.5).float()
                tot += float(dice_coeff(pred, mask.float()))
            n_val += 1
    return {"val_score": tot / max(n_val, 1)}


def eval_stn(model, batches: Iterable[Dict], template, n_classes: int) -> Dict[str, float]:
    """Legacy score of a ``UNetSTN`` or ``CourtReconstruction`` over
    batches: means over batches of the mean cross entropy of the logits
    and of the MSE of the projected template against ``mask / n_classes``,
    and their sum."""
    ce_score = mse_score = 0.0
    n_val = 0
    with _eval_mode(model):
        for batch in batches:
            logits, proj = model(norm_img(_on(model, batch, "image")), template)
            mask = _on(model, batch, "mask").long()
            ce_score += float(cross_entropy_map(logits, mask).mean())
            mse_score += float(mse_map(proj, mask.float() / float(n_classes)).mean())
            n_val += 1
    n = max(n_val, 1)
    return {"val_tot_score": (ce_score + mse_score) / n,
            "val_ce_score": ce_score / n,
            "val_mse_score": mse_score / n}
