"""The plain reference's predict outputs and training steps.

The homography warp is kornia's ``HomographyWarper`` as the original
reference calls it: a normalized meshgrid over the output with its
endpoints, mapped through theta (frame -> court) with kornia's perspective
division, then ``F.grid_sample(align_corners=False)``: nearest for the
predicted court labels, bilinear for the training warp.  The losses are
the reference's: kornia 0.5 focal loss, MSE, the masked point-to-point
reprojection loss (RRMSE), and the consistency loss behind its warm-up
gate.  The optimizer is ``torch.optim.RMSprop`` after elementwise gradient
clipping at 0.1, as the reference's train loop steps it.

Everything runs in float32 with TF32 off (``plain_precision``), and the
court label template is used as loaded: its labels 0..C-1 are the classes.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["plain_precision", "transform_points", "project_poi", "warp_labels_nearest",
           "warp_label_mismatch", "warp_bilinear", "predict", "focal_map", "train_losses", "train_steps",
           "GRAD_CLIP"]

GRAD_CLIP = 0.1
_EPS = 1e-8


@contextlib.contextmanager
def plain_precision():
    """float32 convolutions and matmuls in full float32, not TF32."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def transform_points(theta, pts):
    """kornia ``transform_points``: (B, 3, 3) x (B or 1, N, 2) -> (B, N, 2)."""
    ones = torch.ones_like(pts[..., :1])
    h = torch.cat([pts, ones], -1) @ theta.transpose(1, 2)
    z = h[..., 2:]
    scale = torch.where(z.abs() > _EPS, 1.0 / (z + _EPS), torch.ones_like(z))
    return h[..., :2] * scale


def project_poi(theta, court_poi):
    """Court points in [-1, 1] projected into the frame, in [0, 1]."""
    inv = torch.linalg.inv(theta)
    return transform_points(inv, court_poi[None].expand(theta.shape[0], -1, -1)) / 2 + 0.5


def _axis(n, device, idx=None):
    a = torch.linspace(-1.0, 1.0, n, device=device)
    return a if idx is None else a[idx]


def _grid(theta, out_hw, sample_hw=None):
    """The warp's normalized sampling grid (B, h, w, 2); with ``sample_hw``
    only the points that a nearest resize of the out_hw grid to
    sample_hw keeps (torch's ``mode="nearest"`` indices)."""
    ho, wo = out_hw
    dev = theta.device
    if sample_hw is None:
        xs, ys = _axis(wo, dev), _axis(ho, dev)
    else:
        hs, ws = sample_hw
        xs = _axis(wo, dev, _nearest(wo, ws, dev))
        ys = _axis(ho, dev, _nearest(ho, hs, dev))
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    pts = torch.stack([gx, gy], -1).reshape(1, -1, 2)
    return transform_points(theta, pts).reshape(theta.shape[0], len(ys), len(xs), 2)


def _nearest(n_in, n_out, device):
    scale = float(np.float32(n_in / n_out))
    idx = torch.floor(torch.arange(n_out, dtype=torch.float32, device=device) * scale)
    return idx.long().clamp_max(n_in - 1)


def warp_labels_nearest(labels, theta, out_hw, sample_hw=None):
    """Nearest warp of a (Ht, Wt) label template: (B, h, w) int64 labels,
    0 outside the template."""
    grid = _grid(theta, out_hw, sample_hw)
    tmpl = labels.float()[None, None].expand(theta.shape[0], 1, -1, -1)
    out = F.grid_sample(tmpl, grid, mode="nearest", padding_mode="zeros",
                        align_corners=False)
    return out[:, 0].round().long()


def warp_label_mismatch(labels, theta, warp, tie=0.01):
    """Judge a nearest warp of the (Ht, Wt) label template: ``warp``
    (B, h, w), the labels a program gave for its homographies ``theta``
    (B, 3, 3), against the template pixel nearest to where theta maps each
    output pixel, worked out again in float64 (0 outside the template).
    Pixels whose source point lies within ``tie`` of a pixel boundary, where
    float32 arithmetic may round either way, are left out.  Returns
    (mismatched pixels, compared pixels)."""
    b, h, w = warp.shape
    ht, wt = labels.shape
    dev = warp.device
    ys = torch.linspace(-1.0, 1.0, h, dtype=torch.float64, device=dev)
    xs = torch.linspace(-1.0, 1.0, w, dtype=torch.float64, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    src = transform_points(theta.reshape(b, 3, 3).double(),
                           torch.stack([gx, gy], -1).reshape(1, -1, 2))
    u = ((src[..., 0] + 1.0) * wt - 1.0) / 2.0
    v = ((src[..., 1] + 1.0) * ht - 1.0) / 2.0
    keep = (torch.isfinite(u) & torch.isfinite(v)
            & ((u - u.floor() - 0.5).abs() >= tie) & ((v - v.floor() - 0.5).abs() >= tie))
    iu, iv = torch.round(u), torch.round(v)
    valid = keep & (iu >= 0) & (iu < wt) & (iv >= 0) & (iv < ht)
    lin = torch.where(valid, iv * wt + iu, torch.zeros_like(iu)).long()
    want = torch.where(valid, labels.reshape(-1).long()[lin], torch.zeros_like(lin))
    bad = keep & (want != warp.reshape(b, -1).long())
    return int(bad.sum()), int(keep.sum())


def warp_bilinear(template, theta, out_hw):
    """Bilinear warp of a (Ht, Wt) float template: (B, h, w)."""
    grid = _grid(theta, out_hw)
    tmpl = template[None, None].expand(theta.shape[0], 1, -1, -1)
    return F.grid_sample(tmpl, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)[:, 0]


def predict(model, frames_u8, labels, court_poi, warp_hw):
    """The predict outputs of uint8 NHWC frames: theta (B, 3, 3), poi
    (B, N, 2) and the consistency score (B,), the mean per-pixel cross
    entropy of the logits against the warped court labels sampled at the
    logits' grid."""
    x = frames_u8.permute(0, 3, 1, 2).float() / 255.0
    logits, theta = model(x)
    wm = warp_labels_nearest(labels, theta, warp_hw, sample_hw=tuple(logits.shape[2:]))
    score = F.cross_entropy(logits, wm, reduction="none").mean(dim=(1, 2))
    return {"theta": theta, "poi": project_poi(theta, court_poi), "consist_score": score}


def focal_map(logits, labels, alpha=1.0, gamma=2.0, eps=1e-8):
    """kornia 0.5 ``FocalLoss(reduction='none')`` over NCHW logits."""
    p = torch.softmax(logits, dim=1) + eps
    focal = -alpha * torch.pow(1.0 - p, gamma) * torch.log(p)
    one_hot = F.one_hot(labels, logits.shape[1]).permute(0, 3, 1, 2).float()
    return (one_hot * focal).sum(dim=1)


def train_losses(model, batch, template, court_poi, loss_cfg, step_no):
    """The example conf's objective on one batch: focal segmentation,
    MSE of the bilinear warp against the mask, RRMSE reprojection (times
    its lambda), and the focal consistency loss times its warm-up gate.
    Returns the total and each term."""
    x = batch["image"].permute(0, 3, 1, 2).float()
    mask = batch["mask"].long()
    classes = loss_cfg["mask_classes"]
    logits, theta = model(x)
    warp = warp_bilinear(template, theta, tuple(mask.shape[1:]))
    seg = focal_map(logits, mask).mean() * loss_cfg["seg_lambda"]
    rec = ((warp - mask.float() / classes) ** 2).mean() * loss_cfg["rec_lambda"]
    poi = project_poi(theta, court_poi)
    dist = torch.sqrt(((batch["poi"] - poi) ** 2).sum(-1))
    reproj = ((dist * batch["nonzeros"]).sum(1) / batch["num_nonzero"]).mean() \
        * loss_cfg["reproj_lambda"]
    gate = float(step_no * x.shape[0] >= loss_cfg["consist_start_iter"])
    cons = focal_map(logits, (warp * classes).long()).mean() * loss_cfg["consist_lambda"] * gate
    total = seg + rec + reproj + cons
    return total, {"seg": seg, "rec": rec, "reproj": reproj, "cons": cons}


def train_steps(model, batches, template, court_poi, loss_cfg, on_step=None):
    """RMSprop steps of ``model`` (train mode) over ``batches``; after step
    k, ``on_step(k, model, optimizer, losses)``.  Returns each step's
    total loss."""
    opt = torch.optim.RMSprop(model.parameters(), lr=loss_cfg["lr"], alpha=0.99, eps=1e-8,
                              weight_decay=loss_cfg["weight_decay"], momentum=0.9)
    model.train()
    totals = []
    for k, batch in enumerate(batches):
        opt.zero_grad(set_to_none=True)
        total, terms = train_losses(model, batch, template, court_poi, loss_cfg, k)
        total.backward()
        torch.nn.utils.clip_grad_value_(model.parameters(), GRAD_CLIP)
        opt.step()
        totals.append(float(total.detach()))
        if on_step is not None:
            on_step(k, model, opt, terms)
    return totals
