"""The comparison that decides ``correct``: the plain reference run on the
inputs the program was given, from weights made again from the seed, and
the numbers that hold the program's outputs against it.

A run calls these once its window has closed, its memory peak has been
read and the program's state is freed, so the reference sets no peak.
``quant="fp8"`` puts the control in the reference's place, ``quant="bf16"``
the witness (``reference/lowp.py``): the calibration tool and the tests run
them, a run never does.
"""
from __future__ import annotations

import numpy as np
import torch

import inputs
from reference import ops as rops
from reference.lowp import to_bf16_model, to_fp8_model

__all__ = ["reference_model", "reference_predict", "predict_gaps", "warp_mismatches",
           "norm_gap"]


def reference_model(model_cfg: dict, seed: int, device, quant=None):
    """The reference with the run's weights, made again from the seed."""
    model = inputs.reference_model(model_cfg, device)
    model.load_state_dict(inputs.seeded_state_dict(model_cfg, seed, device), strict=True)
    if quant == "fp8":
        to_fp8_model(model)
    elif quant == "bf16":
        to_bf16_model(model)
    elif quant is not None:
        raise ValueError(quant)
    return model


def reference_predict(model_cfg: dict, seed: int, device, frames, court_labels, court_poi,
                      warp_size, block: int, quant=None):
    """Reference theta (n, 3, 3), poi (n, N, 2) and score (n,) of uint8
    frames (n, H, W, 3), in blocks of ``block`` frames, as float64 numpy."""
    model = reference_model(model_cfg, seed, device, quant).eval()
    labels = torch.as_tensor(court_labels, device=device)
    poi = torch.as_tensor(court_poi, device=device)
    w, h = warp_size
    out = {"theta": [], "poi": [], "consist_score": []}
    with rops.plain_precision(), torch.no_grad():
        for i in range(0, frames.shape[0], block):
            x = frames[i:i + block].to(device)
            res = rops.predict(model, x, labels, poi, (h, w))
            for k in out:
                out[k].append(res[k].double().cpu().numpy())
    del model
    return {k: np.concatenate(v) for k, v in out.items()}


def predict_gaps(answers, ref, keys):
    """The gaps of the program's answers from the reference.

    ``answers``: [(frame indices, {output: array})] as the timed path
    returned them.  For theta and poi: ``<key>_gap``, the largest absolute
    difference of an element, and for theta ``theta_spread``, the largest
    standard deviation of an element of the reference's theta across the
    answered frames (what an answer given to the wrong frame would move).
    For the consistency score, with r the gap of each frame relative to the
    reference's score: ``score_gap``, the largest |r|; ``score_offset``,
    the median r, the part common to every frame; ``score_resid``, the
    largest |r - score_offset|."""
    per = {k: [] for k in keys}
    idx_all = []
    answers = [(slice(i, i + 1) if isinstance(i, int) else i, out) for i, out in answers]
    for idx, out in answers:
        idx_all.append(np.arange(len(ref["theta"]))[idx])
        for k in keys:
            want = ref[k][idx]
            got = np.asarray(out[k], np.float64).reshape(want.shape)
            gap = got - want
            if k == "consist_score":
                gap = gap / np.abs(want)
            else:
                gap = np.abs(gap).reshape(len(gap), -1).max(axis=1)
            gap[~np.isfinite(gap)] = np.inf
            per[k].append(gap.reshape(-1))
    out = {}
    for k in keys:
        g = np.concatenate(per[k]) if per[k] else np.zeros(1)
        if k == "consist_score":
            offset = float(np.median(g)) if np.isfinite(g).all() else np.inf
            out.update(score_gap=float(np.abs(g).max()), score_offset=offset,
                       score_resid=float(np.abs(g - offset).max()))
        else:
            out[f"{k}_gap"] = float(g.max())
    if "theta" in keys and idx_all:
        frames = np.unique(np.concatenate(idx_all))
        out["theta_spread"] = float(ref["theta"][frames].reshape(len(frames), -1)
                                    .std(axis=0).max())
    return out


def warp_mismatches(answers, court_labels, device, block: int = 8):
    """``warp_mismatch``: the pixels where the program's warp labels differ
    from the court template's nearest pixel under the program's own theta
    (``reference.ops.warp_label_mismatch``), summed over ``answers``
    [(frame indices, {"theta", "warp_mask"})]; ``warp_compared``: the
    pixels judged.  With no pixel judged the mismatch reads infinite."""
    labels = torch.as_tensor(court_labels, device=device)
    bad = seen = 0
    for _, out in answers:
        theta = torch.as_tensor(np.asarray(out["theta"]))
        warp = torch.as_tensor(np.asarray(out["warp_mask"]))
        for i in range(0, len(warp), block):
            b, n = rops.warp_label_mismatch(labels, theta[i:i + block].to(device),
                                            warp[i:i + block].to(device))
            bad, seen = bad + b, seen + n
    return {"warp_mismatch": bad if seen else float("inf"), "warp_compared": seen}


def norm_gap(prog: dict, ref: dict, floor_rule=None):
    """The worst leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or the median leaf's, whichever
    is larger.  ``prog`` and ``ref`` map leaf names to norms; leaves that
    ``floor_rule`` names are left out; a leaf the program has no norm for
    reads 0 there.  Returns (gap, leaf, every leaf's gap)."""
    names = [n for n in ref if floor_rule is None or n not in floor_rule]
    median = float(np.median([ref[n] for n in names]))
    gaps = {n: abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], median) for n in names}
    gaps = {n: (g if np.isfinite(g) else np.inf) for n, g in gaps.items()}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf, gaps
