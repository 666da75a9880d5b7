"""Training steps of the example conf, as the train CLI runs them.

A pool of seeded batches (float32 frames in [0, 1], what augmentation
yields, with their label masks and points of interest) sits in pinned host
memory; step i copies batch i mod pool to the card with ``non_blocking``
and runs ``train/loop.train_step`` with the conf's losses and RMSprop.
``in_flight`` steps are outstanding at once: the CLI reads step i-1's logs
while step i runs.  A step is complete when its optimizer update is done
on the card.

Set-up builds the model and optimizer once and drives them through the
first ``reference_steps`` steps with the window's own call, on batches
whose rows all differ; what the check needs is read from them there (each
step's loss, each leaf's first gradient from RMSprop's state, each leaf's
change after the last of them), and the same objects go on into the
window.  After the window the reference takes the same steps from the same
weights and batches.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

import checks
import inputs
import program
from reference import ops as rops

ALPHA = 0.99        # RMSprop's smoothing constant (train/optim.make_optimizer)


def host_batches(r, labels, poi, dev):
    """The pool: ``pool_batches`` seeded batches on the host (pinned on a card)."""
    model_cfg, t = r.config["model"], r.traffic
    b = t["batch"]
    frames, masks, pts, vis = inputs.render(t["pool_batches"] * b, model_cfg["target_size"],
                                            labels, poi, r.seed, dev)
    out = []
    for i in range(t["pool_batches"]):
        s = slice(i * b, (i + 1) * b)
        batch = {"image": frames[s].float() / 255.0, "mask": masks[s].long(),
                 "weight": torch.ones(b, device=dev), "poi": pts[s].float(),
                 "nonzeros": vis[s], "num_nonzero": vis[s].sum(1).clamp_min(1.0)}
        batch = {k: v.cpu() for k, v in batch.items()}
        if dev.type == "cuda":
            batch = {k: v.pin_memory() for k, v in batch.items()}
        out.append(batch)
    return out


def grad_norms_from_state(model, opt):
    """Each leaf's norm of the gradient RMSprop took at its first step
    (clipped, weight decay added): sqrt(sum(square_avg) / (1 - alpha))."""
    out = {}
    for name, p in model.named_parameters():
        st = opt.state.get(p)
        if st and "square_avg" in st:
            out[name] = float(torch.sqrt(st["square_avg"].double().sum() / (1 - ALPHA)))
    return out


def small_leaves(model, fn, most=1 << 16):
    """``fn(name, parameter)`` as float64 on the host for each leaf of at
    most ``most`` elements (what ``look`` reads)."""
    return {n: fn(n, p).detach().double().cpu() for n, p in model.named_parameters()
            if p.numel() <= most}


def change_norms(model, start):
    return {name: float((p.detach().double() - start[name].double()).norm())
            for name, p in model.named_parameters()}


def run(r):
    model_cfg, tc, t = r.config["model"], r.config["train"], r.traffic
    dev = torch.device(r.device)
    b, depth, n_ref = t["batch"], t["in_flight"], t["reference_steps"]
    if dev.type == "cuda":
        program.load_kernels()
    labels, poi = inputs.court(tc["court_size"], model_cfg["mask_classes"])
    model, opt, loss_cfg, train_step = program.train_program(
        model_cfg, tc, inputs.seeded_state_dict(model_cfg, r.seed, dev), dev, b)
    template = torch.as_tensor(labels, device=dev).float() / model_cfg["mask_classes"]
    court_poi = torch.as_tensor(poi, device=dev)
    pool = host_batches(r, labels, poi, dev)

    def issue(i):
        with r.spans.span("h2d"):
            batch = {k: v.to(dev, non_blocking=True) for k, v in pool[i % len(pool)].items()}
        with r.spans.span("train_step"):
            logs = train_step(model, opt, batch, i, template, court_poi, loss_cfg)
        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return logs, event

    def wait(item):
        with r.spans.span("wait"):
            if item[1] is not None:
                item[1].synchronize()
        return time.perf_counter_ns()

    # set-up: the first steps, read for the check
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses, grads, seen = [], None, {}
    for i in range(n_ref):
        logs, _ = issue(i)
        losses.append(float(logs["Tot_loss"]))
        if i == 0:
            grads = grad_norms_from_state(model, opt)
            if r.look:
                seen["grad"] = small_leaves(model, lambda n, p: torch.sqrt(
                    opt.state[p]["square_avg"] / (1 - ALPHA)))
                seen["step1"] = small_leaves(model, lambda n, p: p - start[n])
    changes = change_norms(model, start)
    if r.look:
        seen["change"] = small_leaves(model, lambda n, p: p - start[n])
    del start
    if dev.type == "cuda":
        torch.cuda.synchronize()

    t0 = r.begin_window()
    limit = t0 + int(r.seconds * 1e9)
    inflight, issued, done, t_end = collections.deque(), n_ref, 0, None
    while True:
        if t_end is None and len(inflight) < depth:
            inflight.append(issue(issued))
            issued += 1
            continue
        if not inflight:
            break
        tc_ = wait(inflight.popleft())
        if t_end is None:
            done += 1
            if tc_ >= limit:
                t_end = tc_
    r.end_window()
    steps = issued - n_ref
    r.metrics["train_img_s"] = done * b / ((t_end - t0) * 1e-9)
    r.counters.update(frames_issued=steps * b, units_issued=steps, batch=b)
    r.attempted, r.failed = steps * b, 0
    r.record_memory()
    del model, opt, inflight
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_readings(r, [pool[i % len(pool)] for i in range(n_ref)], labels, poi)
    readings = compare({"losses": losses, "grads": grads, "changes": changes}, ref)
    if r.look:
        readings["look"] = look(seen, ref["seen"], readings["update_leaf"])
    r.compare(readings)


def look(prog, ref, leaf):
    """What moves one leaf's change norm apart: its elements whose change
    after the steps has the other sign on the two sides (``flipped``), the
    first step's sign flips (``flipped_step1``), the gap of the norms over
    the other elements alone (``gap_without_flipped``, against the leaf's
    own norm), and the reference's first gradient on the flipped elements
    over the leaf's median |g| (``flipped_grad_over_median``: median, max),
    beside the program's relative error of |g| over the leaf (median).
    A leaf too large to keep reads only its name."""
    if leaf not in prog["change"]:
        return {"leaf": leaf}
    dp, dr = prog["change"][leaf], ref["change"][leaf]
    g_ref, g_prog = ref["grad"][leaf].abs(), prog["grad"][leaf].abs()
    flipped = torch.sign(dp) != torch.sign(dr)
    rest = ~flipped
    med = float(g_ref.median())
    rel = ((g_prog - g_ref).abs() / g_ref.clamp_min(1e-30))
    over = g_ref[flipped] / med if flipped.any() else torch.zeros(1, dtype=torch.float64)
    return {"leaf": leaf, "elements": int(dp.numel()), "flipped": int(flipped.sum()),
            "flipped_step1": int((torch.sign(prog["step1"][leaf])
                                  != torch.sign(ref["step1"][leaf])).sum()),
            "gap": float(abs(dp.norm() - dr.norm()) / dr.norm()),
            "gap_without_flipped": float(abs(dp[rest].norm() - dr[rest].norm()) / dr.norm()),
            "flipped_grad_over_median": [float(over.median()), float(over.max())],
            "grad_rel_error_median": float(rel.median())}


def reference_readings(r, batches, labels, poi, quant=None):
    """The reference's losses, first-gradient norms and change norms over
    the same steps from the same weights (the control with ``quant``);
    with ``r.look``, also what ``look`` reads, under ``seen``."""
    model_cfg, tc = r.config["model"], r.config["train"]
    dev = torch.device(r.device)
    model = checks.reference_model(model_cfg, r.seed, dev, quant)
    names = [n for n, _ in model.named_parameters()]
    plain = {n.replace(".parametrizations.weight.original", ".weight")
             .replace(".parametrizations.bias.original", ".bias"): n for n in names}
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    cfg = dict(tc, mask_classes=model_cfg["mask_classes"])
    template = torch.as_tensor(labels, device=dev).float() / model_cfg["mask_classes"]
    grads, seen = {}, {}

    def on_step(k, m, opt, terms):
        if k == 0:
            for pn, n in plain.items():
                sq = opt.state[dict(m.named_parameters())[n]]["square_avg"]
                grads[pn] = float(torch.sqrt(sq.double().sum() / (1 - ALPHA)))
            if r.look:
                seen["grad"] = small_leaves(
                    m, lambda n, p: p.grad + tc["weight_decay"] * start[n])
                seen["step1"] = small_leaves(m, lambda n, p: p - start[n])

    with rops.plain_precision():
        losses = rops.train_steps(model, [{k: v.to(dev) for k, v in b.items()} for b in batches],
                                  template, torch.as_tensor(poi, device=dev), cfg, on_step)
    params = dict(model.named_parameters())
    changes = {pn: float((params[n].detach().double() - start[n].double()).norm())
               for pn, n in plain.items()}
    if r.look:
        seen["change"] = small_leaves(model, lambda n, p: p - start[n])
    return {"losses": losses, "grads": grads, "changes": changes, "seen": seen}


def compare(prog, ref):
    """``loss_gap``: the widest relative gap of a step's loss, and
    ``loss1_gap`` that of the first step alone; ``grad_gap`` and
    ``update_gap``: the worst leaf's gap of the first gradient's norm and of
    the change's norm (``checks.norm_gap``), and ``*_median`` the median
    leaf's.  Leaves whose reference gradient is under a thousandth of the
    median leaf's are left out (biases ahead of a train-mode BatchNorm:
    zero but for rounding).  The worst leaves' names ride along as strings."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    gmed = float(np.median(list(ref["grads"].values())))
    still = {n for n, g in ref["grads"].items() if g < 1e-3 * gmed}
    grad_gap, grad_leaf, grad_all = checks.norm_gap(prog["grads"], ref["grads"], still)
    update_gap, update_leaf, update_all = checks.norm_gap(prog["changes"], ref["changes"], still)
    return {"loss_gap": max(gaps), "loss1_gap": gaps[0],
            "grad_gap": grad_gap, "grad_gap_median": float(np.median(list(grad_all.values()))),
            "update_gap": update_gap,
            "update_gap_median": float(np.median(list(update_all.values()))),
            "grad_leaf": grad_leaf, "update_leaf": update_leaf, "left_out": len(still)}


def control(r):
    """The control's readings: the reference in fp8 in the program's place,
    over the same steps."""
    model_cfg, tc, t = r.config["model"], r.config["train"], r.traffic
    dev = torch.device(r.device)
    labels, poi = inputs.court(tc["court_size"], model_cfg["mask_classes"])
    pool = host_batches(r, labels, poi, dev)
    batches = [pool[i % len(pool)] for i in range(t["reference_steps"])]
    low = reference_readings(r, batches, labels, poi, quant="fp8")
    return compare(low, reference_readings(r, batches, labels, poi))
