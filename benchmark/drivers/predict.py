"""Batched predict, as the predict CLI drives its device path.

A pool of seeded uint8 court renders sits in pinned host memory; batch i
is the pool's slice i mod (pool / batch).  Each batch is copied to the
card with ``non_blocking`` (``data/loader.device_prefetch``), run through
``cli/engine.predict_fn`` and copied back by ``cli/predict._to_host``;
``in_flight`` batches are outstanding at once, as the CLI keeps them.
The mix names the outputs kept (theta, the consistency score, K1's warp
labels on the full warp grid).  A frame counts once its outputs are in
host memory.  The window opens on an
idle card and closes at the first batch that completes ``--seconds`` or
more after it: ``predict_frames_s`` is the frames completed over that
time.  Every answer of the window (and of the batches still in flight
when it closed) is then held against the reference on the same frames;
the warp labels of a sample of the batches drawn from the seed (the rest
are dropped as they arrive) are held against the template pixel that the
answer's own theta maps each pixel to.
"""
from __future__ import annotations

import collections
import time

import torch

import numpy as np

import checks
import inputs
import program

KEYS = ("theta", "poi", "consist_score")


def setup(r):
    """The program, the frame pool and the court: the set-up of a run."""
    model_cfg, p, t = r.config["model"], r.config["predict"], r.traffic
    dev = torch.device(r.device)
    if dev.type == "cuda":
        program.load_kernels()
    labels, poi = inputs.court(p["court_size"], model_cfg["mask_classes"])
    bundle = program.predict_bundle(model_cfg, inputs.seeded_state_dict(model_cfg, r.seed, dev),
                                    dev, p["warp_size"], labels, poi, p["fold_bn"])
    fn = program.predict_program(bundle, t["outputs"])
    pool = frames_pool(r, labels, poi, dev)
    if dev.type == "cuda":
        pool = pool.pin_memory()
    return fn, pool, (labels, poi)


def frames_pool(r, labels, poi, dev):
    """The pool of seeded uint8 frames on the host, each under the
    lighting the mix's ``render`` draws."""
    t = r.traffic
    return inputs.render(t["pool"], r.config["model"]["target_size"], labels, poi, r.seed, dev,
                         **t.get("render", {}))[0].cpu()


def warp_sample(r):
    """Which batches, by the order they complete in, keep their warp
    labels for the check: one in ``warp_every``, from an offset drawn
    from the seed."""
    every = r.traffic["warp_every"]
    first = int(np.random.default_rng(inputs.seed_streams(r.seed, 4)[3]).integers(every))
    return lambda i: i % every == first


def issue(r, fn, pool, k, batch, dev):
    x = pool[k * batch:(k + 1) * batch]
    with r.spans.span("h2d"):
        x = x.to(dev, non_blocking=True)
    with r.spans.span("predict_fn"):
        out = fn(x)
    with r.spans.span("to_host"):
        host, event = program.to_host(out, dev)
    return k, host, event


def wait(r, item):
    k, host, event = item
    with r.spans.span("wait"):
        if event is not None:
            event.synchronize()
    return k, host, time.perf_counter_ns()


def window(r, fn, pool):
    """Warm up, then the measured window; returns the answers
    [(pool indices, outputs)] and fills ``r.metrics`` and ``r.counters``."""
    t = r.traffic
    batch, depth = t["batch"], t["in_flight"]
    n_slices = pool.shape[0] // batch
    dev = torch.device(r.device)
    keep_warp = warp_sample(r)
    with torch.inference_mode():
        for k in range(t["warmup_batches"]):
            wait(r, issue(r, fn, pool, k % n_slices, batch, dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = r.begin_window()
        limit = t0 + int(r.seconds * 1e9)
        inflight, done, issued, t_end = collections.deque(), [], 0, None
        while True:
            if t_end is None and len(inflight) < depth:
                inflight.append(issue(r, fn, pool, issued % n_slices, batch, dev))
                issued += 1
                continue
            if not inflight:
                break
            k, host, tc = wait(r, inflight.popleft())
            if not keep_warp(len(done)):
                host.pop("warp_mask", None)
            done.append((k, host, tc))
            if t_end is None and tc >= limit:
                t_end = tc
        r.end_window()
    frames = sum(batch for _, _, tc in done if tc <= t_end)
    r.metrics["predict_frames_s"] = frames / ((t_end - t0) * 1e-9)
    r.counters.update(frames_issued=issued * batch, units_issued=issued, batch=batch)
    r.attempted = issued * batch
    r.failed = 0
    return [(slice(k * batch, (k + 1) * batch), {n: v.numpy() for n, v in host.items()})
            for k, host, _ in done]


def compare(r, answers, pool, court, warp=True):
    """The widest gaps of the answers from the reference, and, with
    ``warp``, the warp labels judged where an answer kept them (the
    control has none)."""
    p, t = r.config["predict"], r.traffic
    dev = torch.device(r.device)
    ref = checks.reference_predict(r.config["model"], r.seed, dev, pool, court[0], court[1],
                                   p["warp_size"], t["reference_block"])
    out = checks.predict_gaps(answers, ref, [k for k in t["outputs"] if k in KEYS])
    if warp and "warp_mask" in t["outputs"]:
        out.update(checks.warp_mismatches([a for a in answers if "warp_mask" in a[1]],
                                          court[0], dev))
    return out


def run(r):
    fn, pool, court = setup(r)
    answers = window(r, fn, pool)
    r.record_memory()
    del fn
    if r.device != "cpu":
        torch.cuda.empty_cache()
    r.compare(compare(r, answers, pool, court))


def control(r, quant="fp8"):
    """The control's readings: the reference in fp8 in the program's place
    on the same frames (with ``quant="bf16"``, the witness's)."""
    model_cfg, p, t = r.config["model"], r.config["predict"], r.traffic
    labels, poi = inputs.court(p["court_size"], model_cfg["mask_classes"])
    pool = frames_pool(r, labels, poi, torch.device(r.device))
    low = checks.reference_predict(model_cfg, r.seed, torch.device(r.device), pool, labels, poi,
                                   p["warp_size"], t["reference_block"], quant=quant)
    return compare(r, [(slice(0, len(pool)), low)], pool, (labels, poi), warp=False)
