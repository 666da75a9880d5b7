#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sports_field_homography_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails, and prints
its seconds:

1. device: a CUDA device must be present; prints the card's name and power
   limit as ``nvidia-smi`` reports them.
2. build: compiles the CUDA kernels from ``csrc/`` (``build/torch_kernels/``),
   one nvcc per source, all at once.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes with batch 8, timed with CUDA events (median of
   several runs), beside one PyTorch library call that computes the same
   function (``library_ms``; the port never calls it) and the kernel's
   bound (the larger of its FLOPs over the card's peak for their type and
   its bytes, each input read and each output written once, over HBM):
     K1 warp      1280x720 template, full grid (the kernels line's entry)
                  and sample_hw=(360, 640): labels equal;
     K2 conv3x3   64->64 at 360x640 and 128->128 at 180x320, with and
                  without the prologue;
     K3 deconv    the four UNet up-convs (up1 1024->512 at 22x40 .. up4
                  128->64 at 180x320);
     K2+stats     64->64 at 360x640 with the prologue, 1024->512 at 45x80;
     K5 wgrad     64->64 at 360x640 with and without the prologue, 128->128
                  at 180x320, 1024->512 at 45x80;
     K7-bwd       360x640x64 (and every UNet level in the levels phase);
     K3-bwd       the same four up-convs;
     K7-fwd       stats of 360x640x64 (f32, the stem's output, and bf16),
                  norm of 360x640x64 (f32: equal bit for bit; bf16);
     K2 two-input 64+64->64 at 360x640 (up4 conv1) and 512+512->512 at
                  45x80 (the bilinear up1 conv1), with and without stats;
     K1 also on a {0, 2} template of 4 classes (label 2 -> 0.5, as JAX's
                  interval table gives it).
   In f32 with TF32 off (elementwise outputs rtol = atol = 1e-4;
   reductions, whose kernels sum in another order, rel-L2 <= 1e-5 against
   the plain version in float64 on the same inputs), and in bf16 against
   the plain version on the same bf16 inputs, which like the kernels
   accumulates in f32 (rtol = atol = 2e-2; reductions rel-L2 <= 1e-3).
   Every reduction kernel is run twice and must repeat bitwise.  K2, K5, K3
   and K3-bwd have two routes, and each call here asserts the one it took:
   f32 on the SIMT kernels (conv3x3.cu, wgrad3x3.cu, deconv2x2.cu), bf16
   on the tensor-core kernels (conv3x3_sm90.cu, wgrad3x3_sm90.cu,
   deconv2x2_sm90.cu); K1 and K7-bwd at these shapes must take their
   16-byte routes (``vec_launches``).  K1 and K7-bwd are also timed bare,
   from a CUDA graph of back-to-back calls (``graph_ms``), which leaves the
   host's per-call cost out.  K3 and K3-bwd are timed here in f32; then each
   bf16 UNet level's K2 (one- and two-input, prologue, stats, dgrad), K5,
   K3 and K3-bwd on the tensor cores, and K7-bwd (whole and bare), checked
   and timed beside its library call and bound (``K2_LEVELS``,
   ``K5_LEVELS``, ``K3_LEVELS``, ``K7_LEVELS``; the K3 and K3-bwd entries
   of the kernels line are their sums over the four up-convs).
4. predict: 16 seeded 640x360 PNG frames, a seeded resnet34 img+mask model
   saved as .pth, the predict CLI in-process (bf16, theta + consistency,
   batch 8, NCAA court).  Checks 16 finite records and that K1, K2 (one-
   and two-input), K3 and K7-fwd's norm launched; then 2 frames in f32 on
   CUDA (TF32 off) against the CPU (plain versions): theta max-abs <=
   2e-4, score <= 1e-3.  Prints the device time of a batch of 8.  Every
   bf16 K2, K5, K3 and K3-bwd launch of the predict, train and test-CLI
   phases must take the tensor-core route (``tc_launches`` ==
   ``launches``), every f32 one of the parity runs the SIMT route; every
   K1 launch of the predict and test-CLI runs and every K7-bwd call of the
   bf16 train runs the 16-byte route.  K1 runs once a batch, on the
   sampled 360x640 grid.
4b. predict full outputs: the same frames and .pth through the predict CLI
   with theta, consistency, segm and warp masks and poi at the default
   1280x720 ``out_size`` (BASELINE config #2 less the debug renders: the
   machine has no cv2), once as gray PNGs and once as RGB pickle streams.
   K1 must run once a batch on the full 1280x720 grid, every K1, K2 and K3
   launch on its fast route; theta and score equal the predict phase's
   JSON exactly; 16 masks of each kind decode, frame 0's warp mask equals
   K1's plain version on the CPU at its JSON theta, the segm masks the
   resized argmax, the RGB masks the gray ones through the palette; on the
   card the nearest downsample of a batch's full-grid labels equals the
   sampled-grid labels bit for bit.  ``--resume`` after 8 recorded frames,
   a torn record and torn mask streams predicts 8 frames and reproduces
   the merged JSON and streams.  f32 CUDA against the CPU on 2 frames:
   theta <= 2e-4, score <= 1e-3, poi <= 5e-4, warp labels differ on < 0.1 %
   of pixels.  Prints the device time of a full-output batch of 8 (D2H
   included) beside the theta+consistency batch's, two turns each, and
   the CLI's frames/s and its writer thread's busy share, over the 16
   frames and over 64 (the 16 four times; the theta+consistency CLI too).
5. train: a seeded synthetic 640x360 set (24 train, 8 validation frames),
   a JSON conf (the flagship, bf16, the example conf's losses and RMSprop,
   consist_start_iter 0), the train CLI in-process: 3 steps at batch 8 and
   one validation pass.  Checks finite losses, that K2 (with stats, two-
   input, as dgrad), K3, K3-bwd, K5, K7-fwd (stats, norm) and K7-bwd
   launched, and that the written .pth loads into the predict CLI.  Prints
   ms/step and img/s at batch 8.
5b. data parallel: two ranks share cuda:0 over gloo (NCCL refuses two
   ranks on one card; the ranks find that out from the device UUIDs, and
   the backend they took is checked).  First the split K7-bwd
   (``bn_relu_bwd_sums``, then ``bn_relu_bwd_dx``: the halves a rank runs
   around the all-reduce of the sums) against its plain versions at
   360x640x64, batch 8 (f32 sums against exact sums over the same ReLU
   mask, rel-L2 1e-5, dx 1e-4; bf16 1e-3 and 2e-2; bitwise repeat; the
   16-byte route), timed beside ``torch.batch_norm_backward_reduce`` +
   ``batch_norm_backward_elemt``.  Then the train CLI on both ranks
   (``--num_hosts 2``, child processes): the flagship at 640x360, bf16,
   global batch 16, 3 steps (the tail of 9 split 5 + 4), one validation;
   each rank prints its launches: K2 (with stats, two-input, dgrad), K5,
   K3, K3-bwd, K7-fwd stats and norm and both K7-bwd halves must launch,
   the one-call K7-bwd and every plain K7-bwd version never (a rank
   counts calls of the plain versions), every bf16 launch on its fast
   route; both ranks log the same losses, rank 0 writes the checkpoint;
   the steps' host ms and the part of each spent in all-reduces (each
   timed after a device sync).  Then three rank pairs at once on the
   card.  The harness (``python -m ...parallel.distributed --smoke``), f32
   at 128x72, global batch 4, under cuDNN's deterministic algorithms: one
   RMSprop step against the same step in one process on the card (one
   parameter digest on both ranks; loss rtol 2e-3, gradients rel-L2 <
   2e-2, running stats rtol 1e-3 / atol 1e-5: the CPU test's bounds; the
   worst leaf, and the same one-process step with the ranks' rows swapped,
   printed); the JAX package's multi-step contract: 4 SGD steps, one
   digest on both ranks, a bit-equal resume from step 2's checkpoint, and
   parameters within 1e-5 of one process; and the predict CLI on
   32 frames over two hosts (K1, K2, K3 and K7-fwd's norm launched on
   each), merged, against one process: theta <= 2e-4, score <= 1e-3, and
   how many records are equal.
6. train parity: one f32 train step (TF32 off) at 64x36, batch 3, on CUDA
   and on the CPU: per-loss values rtol 2e-3 / atol 1e-4 (consistency
   1e-2 / 1e-3), every gradient rel-L2 < 2e-2, with both runs' distance to
   a float64 run printed.  And every UNet module of such steps at 64x36
   batch 3, 128x72 batch 3 and 256x144 batch 2, replayed from the inputs
   and cotangent it
   had in the step, on CUDA: output and every gradient within rel-L2
   max(1e-4, 4x the CPU f32's) of float64 where CUDA and the CPU took the
   same ReLU masks, and within 1e-2 of the CPU where a mask bit differs
   (the whole step's gradients are too sensitive to rounding at these
   sizes to hold the kernels to; ``scripts/torch_train_parity.py``
   measures that).
7. predict and train, bilinear UNet (``--unet_bilinear``): phases 4 and 5
   for that configuration; K3 and K3-bwd must not launch.
8. train parity, bilinear: phase 6's step, each gradient within 2e-2 plus
   twice the rel-L2 by which one ulp on the CPU weights moves it (this
   case's rounding floor), and its four Up modules replayed at 128x72.
9. test CLI: the checkpoint test CLI on phase 5's .pth over its 8
   validation frames (bf16): finite scores in ``test_scores.txt``, K1 on
   the full 640x360 warp grid, K2 (one- and two-input), K3 and K7-fwd's
   norm launched; then in f32, CUDA against the CPU: every score within
   rtol 1e-3.
10. train example conf: ``conf/train_reconstructor.yaml.example`` as JSON
   (the card's machine has no PyYAML) over 57 synthetic 640x360 frames:
   batch 26 (two full batches and a true tail of 5), bf16, the conf's
   host augmentation (jitter, blur, hflip), focal / MSE / RRMSE / focal,
   RMSprop, weight decay 1e-6, TensorBoard at ``log_dir`` (or the logged
   line that disables it), a validation after step 3.  Every training
   kernel's launches counted from 0 around the run, with the routes of
   phase 5; the steps' host seconds and loader waits; ms/step of the
   conf's step at batch 26 (float32 frames copied from pinned memory, the
   consistency gate shut) on CUDA events.  Then ``grad_accum 2`` with
   ``tail pad`` at batch 8: one optimizer step per two batches (the last
   micro-batch the true tail), the same route checks.  Then the SIGTERM
   save and ``--resume``: the CLI as a child process under its own cuDNN
   settings at batch 8 with augmentation,
   validation and async checkpoints, twice uninterrupted, then SIGTERM'd
   after its third step and resumed; the resumed weights equal an
   uninterrupted run's bit for bit where the two uninterrupted runs are
   bit-equal, and elsewhere stay within ``RESUME_SPREAD`` times their
   spread.
11. predict resnet50: the predict path with a resnet50 STN at 640x360,
   batch 8, f32 CUDA (TF32 off) against the CPU (theta <= 2e-4), then the
   bf16 batch time.
12. serve: the online server (``python -m sports_field_homography_tpu_torch.serve.server``)
   at the flagship's full width: a seeded .pth with a JSON conf.yaml, bf16,
   BN folded, theta + poi + consistency, max batch 32, 8 ms window, buckets
   1..32.  A child process serves; the clients run here: 32 sequential
   requests (client p50/p99), 32 threads x 8 requests over 64 seeded
   640x360 PNGs (requests/s, client p50/p99, the batch histogram and mean
   occupancy from /stats), a 1280x720 PNG (400 without cv2) and a JPEG
   (400), then SIGTERM (exit 0); a second child SIGTERM'd with 3 requests
   parked in a 2 s window (all 200, exit 0).  In this process
   (``create_server``): K1, K2 (one- and two-input), K3 and K7-fwd's norm
   launched by 32 requests in one bucket-32 batch and by the same frames
   served alone, every launch on its fast route; each frame's theta in the
   bucket-32 batch against alone (bf16, printed, and whether the UNet's
   logits or the STN's theta moves; f32 with TF32 off, <= 2e-4; each frame
   nearest its own: no slice mix-up); the program's device
   ms at every bucket and the share of the load's wall clock its batches
   cover; f32 CUDA
   against ``--device cpu`` on 2 frames (theta <= 2e-4, score <= 1e-3, poi
   <= 5e-4); the host decode ms of a frame on both ``decode_png`` paths
   (filter 0 and Sub).
13. serve artifact: phase 12's model exported on the card with
   ``python -m sports_field_homography_tpu_torch.cli.export_serving
   --buckets 1,2,4,8,16,32`` (``torch.export`` programs with the weights
   inside, bf16 where the program casts them to bf16 at every use), each
   bucket's program loaded alone and held to the live ``predict_fn`` bit
   for bit on the same frames, with K2 17 (4 two-input), K3 4, K7-fwd's
   norm 9 and K1 1 launches a batch on the tensor-core and float4 routes
   (export seconds, MB, load seconds, device ms beside the live program's);
   then ``serve.server --serving_artifact`` in a child process under phase
   12's load (start seconds, requests/s, p50/p99, SIGTERM exit 0), in this
   process the same launches through the batcher (33 batches), the bf16
   STN replayed alone at buckets 32 and 1 (the ResNet trunk's features,
   then the linear head on the same features), and an f32 artifact
   exported on the card against one exported on the CPU (theta <= 2e-4,
   score <= 1e-3, poi <= 5e-4).  Phase 3 also times the host cost of one K1
   and one K2 call at bucket 1's shapes through each binding: the bare
   ctypes launch, the ``Library.define`` operator the port uses, a
   ``torch.library.custom_op`` of the same implementation, and the public
   wrapper.
14. legacy: the legacy models (``models/legacy.py``) at 640x360 from one
   seed: the deconv UNet of ``utils/hubconf.unet`` (K2, K7-fwd's norm, K3),
   then ``UNetSTN`` and ``CourtReconstruction`` on the bilinear UNet (no
   K3); bf16 at batch 8, every launch counted from 0 and on the tensor
   cores, ms a batch; f32 (TF32 off) CUDA against the CPU on 2 frames
   (logits rtol 1e-3 / atol 2e-4, theta <= 2e-4, the projection of the
   CPU's theta on the card within 1e-5); ``eval_net`` (4 classes, and 1
   class through the dice path) and ``eval_stn`` over two seeded batches
   of 2, CUDA against the CPU, rtol 1e-3; ``geometry/court.Warper`` on its
   default device, the card, at 1280x720 against ``cuda=False``: < 0.1 %
   of pixels apart.
15. pitch: the soccer-pitch variant (BASELINE config #5): 24 training and
   8 validation 640x360 frames rendered from ``assets/pitch_mask_nc4_hd.png``
   (RGBA class colours, converted to a label template by
   ``data/synthetic.py``) with the 33 points of
   ``template_pitch_points.json``; the train CLI for 3 steps at batch 8
   with the hflip and ``pitch-poi-flip-mapping.json`` (phase 5's kernel and
   route checks), the predict CLI on the validation frames from its
   checkpoint (33 finite points a frame), and f32 CUDA against the CPU on 2
   frames from that checkpoint: unit-normalized theta <= 2e-4 (a trained
   head's theta is far from unit size; its raw gap and size are printed),
   poi <= 5e-4, score <= 1e-3.
16. video and viz (BASELINE config #3), where cv2 imports (else one line
   says it skipped): 16 seeded 1280x720 frames written as MJPG in an .avi
   (the writer's seconds; decode by ``_VideoDecodePool`` and sequentially,
   timed); the predict CLI with ``--video_path``, ``debug`` and pickled
   segm masks on phase 4's .pth (K1 once a batch on the full 1280x720
   grid, every launch on its fast route, 16 records, debug renders and
   masks; frames/s and the writer's busy share); the f32 CUDA records of a
   4-frame clip against the CPU run's (theta 2e-4, score 1e-3, poi 5e-4
   within a frame of the frame, and 5e-4 of their distance for the points
   the seeded head sends tens of frame widths out);
   then ``cli.viz_preds`` on the 16 records with the threshold at their
   median score: K1 once a warped frame on the float4 route, the CUDA
   renders equal to the CPU renders byte for byte, ``--no_encode`` unless
   an ``ffmpeg`` binary is on PATH (then ``output.mp4`` too).

The last two lines are JSON: the kernel table (each kernel's launches in
the deconv predict run, K1's in the png full-output run, whose full grid
its entry times, or for the training kernels the deconv train run, the
split K7-bwd's (``bn_relu_bwd_split``) rank 0's in the data-parallel run;
for the f32 SIMT routes ``conv3x3_f32`` / ``deconv2x2_f32`` and
``wgrad3x3_f32`` / ``deconv2x2_backward_f32`` the deconv predict's and
train step's f32 parity runs; its error, times and bound),
then ``{"ok": true, "device": {...}}``.
"""
import collections
import gc
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
from typing import Optional

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "sports_field_homography_tpu_torch"
BATCH = 8
COURT_IMG = os.path.join(REPO, "assets", "mask_ncaa_v4_nc4_m_onehot.png")
COURT_POI = os.path.join(REPO, "assets", "template_ncaa_v4_points.json")


# The card's published peaks (H100 SXM, dense): bf16 tensor cores, f32
# outside the tensor cores, HBM bandwidth; a kernel's bound is the larger of
# its operations over the rate for its type and its bytes over HBM.
PEAK_BF16, PEAK_F32, HBM = 989e12, 67e12, 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, n_bytes: float, rate: float = PEAK_BF16):
    """(least milliseconds the card could take, which side bounds it)."""
    t_ops, t_bytes = flops / rate * 1e3, n_bytes / HBM * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def entry(err, ms, plain_ms, library_ms, bnd):
    """One kernel's measurements for the kernels line."""
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1]}


def nchw(t):
    return t.permute(0, 3, 1, 2)


def oihw(w):
    return w.permute(3, 2, 0, 1).contiguous()


def cuda_ms(fn, warmup: int = 2, runs: int = 7) -> float:
    """Median milliseconds of ``fn()`` over ``runs``, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, n: int = 20, runs: int = 5) -> float:
    """Median device milliseconds of one ``fn()`` with the host out of the
    way: ``n`` calls captured back to back in one CUDA graph (the wrappers
    launch on the current stream, which under capture is the capturing
    one), the graph replayed between two CUDA events, divided by ``n``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):     # warm-up off the default stream, as capture wants
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"device: {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return card


def phase_build():
    from sports_field_homography_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.load_library()
    secs = time.perf_counter() - t0
    log(f"build: kernels ready in {secs:.1f} s (nvcc {build.load_library.build_seconds:.1f} s) "
        f"in {build.build_dir()}")
    for f in sorted(build.build_dir().glob("*.log")):
        for line in f.read_text().splitlines():
            if "registers" in line or "error" in line.lower():
                log("  ptxas: " + line.strip())


def _compare(name, got, ref, rtol, atol):
    import torch

    err = (got.float() - ref.float()).abs().max().item()
    ok = torch.allclose(got.float(), ref.float(), rtol=rtol, atol=atol)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with the plain version "
                             f"(max abs err {err:.3e}, rtol=atol={rtol})")
    return err


def routed(kernel, tc, call):
    """``call()``, which must launch ``kernel`` (``conv3x3``, ``wgrad3x3``,
    ``deconv2x2`` or ``deconv2x2_backward``) at least once: every launch on
    the tensor-core route when ``tc``, none of them otherwise.  Returns what
    ``call`` returned."""
    n0, t0 = kernel.launches, kernel.tc_launches
    out = call()
    n, t = kernel.launches - n0, kernel.tc_launches - t0
    if n <= 0 or t != (n if tc else 0):
        raise AssertionError(f"{kernel.__name__}: {t} of {n} launches took the tensor-core "
                             f"route, expected {'all' if tc else 'none'}")
    return out


def vec_routed(kernel, call):
    """``call()``, which must call ``kernel`` (``warp_nearest`` or
    ``bn_relu_bwd``) at least once, every call on its 16-byte route.
    Returns what ``call`` returned."""
    n0, v0 = kernel.launches, kernel.vec_launches
    out = call()
    n, v = kernel.launches - n0, kernel.vec_launches - v0
    if n <= 0 or v != n:
        raise AssertionError(f"{kernel.__name__}: {v} of {n} calls took the 16-byte route, "
                             "expected all")
    return out


def phase_kernels(dev, card):
    """Each kernel against its plain version at the path's shapes."""
    import torch
    import torch.nn.functional as F

    from sports_field_homography_tpu_torch.data.assets import open_court_template
    from sports_field_homography_tpu_torch.geometry.warp import subsampled_warp_grid, warp_grid
    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain
    from sports_field_homography_tpu_torch.ops.deconv import deconv2x2, deconv2x2_plain
    from sports_field_homography_tpu_torch.ops.warp import (
        template_value_table, warp_nearest, warp_nearest_plain)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    # --- K1: nearest warp -------------------------------------------------
    labels_np = open_court_template(COURT_IMG, 4, size=(1280, 720))
    labels = torch.from_numpy(labels_np).to(dev)
    values = template_value_table(labels_np, 4).to(dev)
    eye = torch.eye(3, device=dev).expand(BATCH, 3, 3)
    noise = torch.randn((BATCH, 3, 3), generator=gen, device=dev)
    theta = eye + noise * torch.tensor([[0.1, 0.1, 0.2], [0.1, 0.1, 0.2],
                                        [0.05, 0.05, 0.0]], device=dev)
    tmpl = labels.float().expand(BATCH, 1, 720, 1280).contiguous()
    for sample in (None, (360, 640)):
        def run():
            return warp_nearest(labels, theta, (720, 1280), values, sample)

        got = vec_routed(warp_nearest, run)
        ref = warp_nearest_plain(labels, theta, (720, 1280), values, sample)
        torch.cuda.synchronize()
        n_diff = int((got != ref).sum().item())
        covered = float((got > 0).float().mean().item())
        if n_diff:
            raise AssertionError(f"K1 warp sample_hw={sample}: {n_diff} labels differ")
        ms, bare = cuda_ms(run), graph_ms(run)
        pms = cuda_ms(lambda: warp_nearest_plain(labels, theta, (720, 1280), values, sample))
        bnd = bound(0, nbytes(labels, theta, got))
        # yardstick: F.grid_sample(nearest) of the float template at the
        # same sample points (grid made beforehand, not timed)
        grid = (subsampled_warp_grid(theta, (720, 1280), sample) if sample
                else warp_grid(theta, 720, 1280))

        def library():
            return F.grid_sample(tmpl, grid, mode="nearest", align_corners=False)

        lib, lib_bare = cuda_ms(library), graph_ms(library)
        log(f"K1 warp_nearest 1280x720 sample_hw={sample} B={BATCH}: labels equal "
            f"({got.numel()} samples, {covered:.1%} on the court), float4 stores; kernel "
            f"{ms:.4f} ms timed whole, {bare:.4f} ms bare (CUDA graph of 20), plain {pms:.4f} "
            f"ms; library F.grid_sample(nearest) {lib:.4f} ms whole, {lib_bare:.4f} bare; "
            f"bound {bnd[0]:.4f} ms ({bnd[1]}), bare / bound {bare / bnd[0]:.2f}, kernel / "
            f"library timed whole {ms / lib:.2f} [{card}]")
        if sample is None:      # the full-output predict's grid, where K1 does the most
            results["warp_nearest"] = entry(0.0, ms, pms, lib, bnd)
        del grid
    del tmpl
    # a template that skips a label ({0, 2} of 4 classes): the value table
    # gives label 2 the interval table's 0.5, and the card agrees bitwise
    gap_np = np.zeros((36, 64), np.uint8)
    gap_np[6:30, 10:50] = 2
    gap_vals = template_value_table(gap_np, 4).to(dev)
    gap = torch.from_numpy(gap_np).to(dev)
    for sample in (None, (18, 32)):
        got = warp_nearest(gap, theta, (36, 64), gap_vals, sample)
        ref = warp_nearest_plain(gap, theta, (36, 64), gap_vals, sample)
        torch.cuda.synchronize()
        if not torch.equal(got, ref) or float(got.max()) != 0.5:
            raise AssertionError(f"K1 gap template sample_hw={sample}: kernel and plain "
                                 f"version differ, or label 2 is not 0.5")
    log("K1 warp_nearest on a {0, 2} template of 4 classes: labels equal to the plain "
        "version bit for bit, label 2 -> 0.5 (the interval table's value)")

    # --- K2: conv3x3: f32 on the SIMT kernel, bf16 on the tensor cores -------
    k2_err, k2_ms = 0.0, None
    for (h, w, c) in ((360, 640, 64), (180, 320, 128)):
        x32 = torch.randn((BATCH, h, w, c), generator=gen, device=dev)
        wt = torch.randn((3, 3, c, c), generator=gen, device=dev) / (3.0 * c ** 0.5)
        b = torch.randn((c,), generator=gen, device=dev) * 0.1
        pro = (torch.randn((c,), generator=gen, device=dev) * 0.1,
               torch.rand((c,), generator=gen, device=dev) + 0.5,
               torch.randn((c,), generator=gen, device=dev) * 0.1)
        for prologue in (None, pro):
            tag = f"{c}->{c} at {h}x{w}{' +prologue' if prologue else ''}"
            got = routed(conv3x3, False, lambda: conv3x3(x32, wt, b, prologue))
            err = _compare(f"K2 f32 {tag}", got, conv3x3_plain(x32, wt, b, prologue), 1e-4, 1e-4)
            ms = cuda_ms(lambda: conv3x3(x32, wt, b, prologue))
            pms = cuda_ms(lambda: conv3x3_plain(x32, wt, b, prologue))
            log(f"K2 conv3x3 f32 (SIMT) {tag}: max abs err {err:.2e}; kernel {ms:.3f} ms, "
                f"plain (cuDNN f32) {pms:.3f} ms [{card}]")
            if c == 64 and prologue is None:
                lib32 = cuda_ms(lambda: F.conv2d(nchw(x32), oihw(wt), b, padding=1))
                bnd32 = bound(2.0 * BATCH * h * w * 9 * c * c, nbytes(x32, wt, got), PEAK_F32)
                log(f"K2 f32 library F.conv2d (f32, TF32 off) {tag}: {lib32:.3f} ms; bound "
                    f"{bnd32[0]:.3f} ms ({bnd32[1]}) [{card}]")
                results["conv3x3_f32"] = entry(err, ms, pms, lib32, bnd32)
            xb, wb = x32.bfloat16(), wt.bfloat16()
            got = routed(conv3x3, True, lambda: conv3x3(xb, wb, b, prologue))
            ref = conv3x3_plain(xb.float(), wb.float(), b, prologue)
            errb = _compare(f"K2 bf16 {tag}", got, ref, 2e-2, 2e-2)
            ms_b = cuda_ms(lambda: conv3x3(xb, wb, b, prologue))
            pms_b = cuda_ms(lambda: conv3x3_plain(xb, wb, b, prologue))
            log(f"K2 conv3x3 bf16 (tensor cores) {tag}: max abs err vs f32 {errb:.2e}; kernel "
                f"{ms_b:.3f} ms, plain (cuDNN) {pms_b:.3f} ms [{card}]")
            k2_err = max(k2_err, errb)
            if c == 64 and prologue is None:
                k2_ms = (ms_b, pms_b)
                wo = oihw(wb)
                lib = cuda_ms(lambda: F.conv2d(nchw(xb), wo, b.bfloat16(), padding=1))
                bnd = bound(2.0 * BATCH * h * w * 9 * c * c, nbytes(xb, wb, got))
                log(f"K2 library F.conv2d (bf16, channels_last) {tag}: {lib:.3f} ms; bound "
                    f"{bnd[0]:.3f} ms ({bnd[1]}) [{card}]")
                k2_lib = (lib, bnd)
            del got, ref, xb, wb
        del x32
    results["conv3x3"] = entry(k2_err, *k2_ms, *k2_lib)

    # --- K3: deconv k2s2 at the four up-convs: f32 on the SIMT kernel, bf16
    # on the tensor cores (timed per level in phase_levels) -----------------
    err32, errb, ms32, pms32, lib32, flops, n_bytes = 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0
    for tag, h, w, cin in K3_LEVELS:
        cout = cin // 2
        x32 = torch.randn((BATCH, h, w, cin), generator=gen, device=dev)
        wt = torch.randn((cin, 2, 2, cout), generator=gen, device=dev) / cin ** 0.5
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1
        got = routed(deconv2x2, False, lambda: deconv2x2(x32, wt, b))
        err = _compare(f"K3 f32 {tag}", got, deconv2x2_plain(x32, wt, b), 1e-4, 1e-4)
        xb, wb = x32.bfloat16(), wt.bfloat16()
        eb = _compare(f"K3 bf16 {tag}", routed(deconv2x2, True, lambda: deconv2x2(xb, wb, b)),
                      deconv2x2_plain(xb.float(), wb.float(), b), 2e-2, 2e-2)
        ms = cuda_ms(lambda: deconv2x2(x32, wt, b))
        pms = cuda_ms(lambda: deconv2x2_plain(x32, wt, b))
        xn, wt_io = nchw(x32), wt.permute(0, 3, 1, 2).contiguous()    # (Cin, Cout, 2, 2)
        lib = cuda_ms(lambda: F.conv_transpose2d(xn, wt_io, b, stride=2))
        log(f"K3 deconv2x2 {tag}: f32 (SIMT) max abs err {err:.2e}, bf16 (tensor cores) vs "
            f"f32 {eb:.2e}; f32 kernel {ms:.3f} ms, plain (cuDNN f32) {pms:.3f} ms, library "
            f"F.conv_transpose2d f32 {lib:.3f} ms [{card}]")
        err32, errb = max(err32, err), max(errb, eb)
        ms32, pms32, lib32 = ms32 + ms, pms32 + pms, lib32 + lib
        flops += 2.0 * BATCH * h * w * cin * 4 * cout
        n_bytes += nbytes(x32, wt, got)
        del x32, xb, got, xn
    bnd = bound(flops, n_bytes, PEAK_F32)
    log(f"K3 deconv2x2 f32 (SIMT) all four up-convs: kernel {ms32:.3f} ms, plain {pms32:.3f} "
        f"ms, library {lib32:.3f} ms; bound {bnd[0]:.3f} ms ({bnd[1]}); bf16 max abs err "
        f"{errb:.2e} [{card}]")
    results["deconv2x2_f32"] = entry(err32, ms32, pms32, lib32, bnd)
    binding_host_cost(dev, card)
    return results


def _host_us(fns, n: int = 300) -> dict:
    """Median host microseconds of one call of each of ``fns`` (name ->
    callable): the launch alone (the clock stops before the device is
    waited on), the stream drained between calls so that no call waits on
    a full launch queue, the callables taken in turns so that a drift of
    the host's clock speed falls on all of them alike."""
    import torch

    for f in fns.values():
        for _ in range(20):
            f()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(n):
        for k, f in fns.items():
            t0 = time.perf_counter()
            f()
            times[k].append(time.perf_counter() - t0)
            torch.cuda.synchronize()
    return {k: statistics.median(v) * 1e6 for k, v in times.items()}


def binding_host_cost(dev, card):
    """The host cost of one kernel call through each binding, for K1 and K2
    at bucket 1's shapes (one 640x360 frame): the bare ctypes launch (the
    operator's CUDA implementation called as a function), the operator as
    ``ops/library.py`` binds it (``Library.define`` + ``impl``), the same
    implementation bound with ``torch.library.custom_op``, and the public
    wrapper that the model calls (device checks, the weight cast, the
    operator).  Each binding's output must equal the bare call's."""
    import torch

    from sports_field_homography_tpu_torch.data.assets import open_court_template
    from sports_field_homography_tpu_torch.ops import conv3x3 as k2
    from sports_field_homography_tpu_torch.ops import warp as k1

    gen = torch.Generator(device=dev).manual_seed(1)
    labels_np = open_court_template(COURT_IMG, 4, size=(640, 360))
    labels = torch.from_numpy(labels_np).to(dev)
    values = k1.template_value_table(labels_np, 4).to(dev)
    theta = torch.eye(3, device=dev)[None] + 0.01 * torch.randn((1, 3, 3), generator=gen,
                                                                 device=dev)
    x = torch.randn((1, 360, 640, 64), generator=gen, device=dev).bfloat16()
    w = (torch.randn((3, 3, 64, 64), generator=gen, device=dev) / 24.0).bfloat16()
    b = torch.randn((64,), generator=gen, device=dev) * 0.1
    Tensor = torch.Tensor

    @torch.library.custom_op("sfh_probe::warp_nearest", mutates_args=(), device_types="cuda")
    def warp_probe(template_labels: Tensor, theta: Tensor, values: Tensor,
                   out_hw: list[int]) -> Tensor:
        return k1._warp_cuda(template_labels, theta, values, out_hw, None)

    @torch.library.custom_op("sfh_probe::conv3x3", mutates_args=(), device_types="cuda")
    def conv_probe(x: Tensor, w: Tensor, bias: Optional[Tensor]) -> Tensor:
        return k2._conv3x3_cuda(x, w, bias, None, None, None, None, None)

    cases = {
        "K1 warp_nearest (1, 360, 640)": (
            lambda: k1._warp_cuda(labels, theta, values, [360, 640], None),
            lambda: torch.ops.sfh.warp_nearest.default(labels, theta, values, [360, 640], None),
            lambda: warp_probe(labels, theta, values, [360, 640]),
            lambda: k1.warp_nearest(labels, theta, (360, 640), values)),
        "K2 conv3x3 64->64 (1, 360, 640) bf16": (
            lambda: k2._conv3x3_cuda(x, w, b, None, None, None, None, None),
            lambda: torch.ops.sfh.conv3x3.default(x, w, b, None, None, None, None, None),
            lambda: conv_probe(x, w, b),
            lambda: k2.conv3x3(x, w, b)),
    }
    out = {}
    for name, (bare, op, probe, wrapper) in cases.items():
        ref = bare()
        for f in (op, probe, wrapper):
            if not torch.equal(f(), ref):
                raise AssertionError(f"binding host cost {name}: a binding's output differs")
        us = _host_us({"ctypes": bare, "Library.define": op, "custom_op": probe,
                       "wrapper": wrapper})
        out[name] = us
        log(f"host cost of one call, {name}: bare ctypes launch {us['ctypes']:.1f} us, "
            f"Library.define/impl operator {us['Library.define']:.1f} us (+"
            f"{us['Library.define'] - us['ctypes']:.1f}), torch.library.custom_op "
            f"{us['custom_op']:.1f} us (+{us['custom_op'] - us['ctypes']:.1f}), the public "
            f"wrapper (checks, cast, operator) {us['wrapper']:.1f} us; median of 300 in "
            f"turns, the stream drained between calls [{card}]")
    return out


class recording_k1_grids:
    """Context manager: a list of the (out_hw, sample_hw) of every K1 call
    the Reconstructor makes inside it."""

    def __enter__(self):
        from sports_field_homography_tpu_torch.models import reconstructor

        self.grids, self.k1 = [], reconstructor.warp_nearest

        def recording_k1(labels, theta, out_hw, values, sample_hw=None):
            self.grids.append((tuple(out_hw), sample_hw))
            return self.k1(labels, theta, out_hw, values, sample_hw)

        reconstructor.warp_nearest = recording_k1
        return self.grids

    def __exit__(self, *exc):
        from sports_field_homography_tpu_torch.models import reconstructor

        reconstructor.warp_nearest = self.k1


def _predict_launches(kernels):
    """Launch counts of the predict path's kernels, K2's single- and
    two-input launches apart."""
    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3

    launches = {name: fn.launches for name, fn in kernels.items()}
    launches["conv3x3_dual"] = conv3x3.dual_launches
    launches["conv3x3"] -= conv3x3.dual_launches
    return launches


def write_seeded_model(ckpt, bilinear=False):
    """The flagship (UNet deconv, or bilinear, + ResNet34 img+mask) from seed
    0, its regression head varied so that theta depends on the frame,
    saved as a reference-keyed .pth."""
    import torch

    from sports_field_homography_tpu_torch.models import Reconstructor, ReconstructorConfig
    from sports_field_homography_tpu_torch.models.layers import init_weights

    model = Reconstructor(ReconstructorConfig(resnet_name="resnet34", resnet_input="img+mask",
                                              unet_bilinear=bilinear))
    gen = torch.Generator().manual_seed(0)
    init_weights(model, gen)
    with torch.no_grad():      # fresh init regresses identity: vary theta
        model.resnet_reg.reg.weight.copy_(
            torch.randn(model.resnet_reg.reg.weight.shape, generator=gen) * 5e-3)
    os.makedirs(os.path.dirname(ckpt))
    torch.save(model.state_dict(), ckpt)


def phase_predict(dev, card, work, bilinear=False):
    """The predict CLI on 16 seeded frames (deconv or bilinear UNet), f32
    CUDA against the CPU on 2 frames, and the device time of a batch."""
    import torch

    from sports_field_homography_tpu_torch.cli import predict as predict_cli
    from sports_field_homography_tpu_torch.cli.engine import build_model
    from sports_field_homography_tpu_torch.data.dataset import BasicDataset
    from sports_field_homography_tpu_torch.data.png import write_png
    from sports_field_homography_tpu_torch.ops.bn_relu import bn_relu_norm
    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3
    from sports_field_homography_tpu_torch.ops.deconv import deconv2x2
    from sports_field_homography_tpu_torch.ops.warp import warp_nearest

    variant = "bilinear" if bilinear else "flagship"
    frames = os.path.join(work, "game0")
    if not os.path.isdir(frames):
        os.makedirs(frames)
        rng = np.random.default_rng(0)
        for i in range(16):
            write_png(os.path.join(frames, f"{i:06d}.png"),
                      rng.integers(0, 256, size=(360, 640, 3), dtype=np.uint8))
    ckpt = os.path.join(work, variant, "model.pth")
    write_seeded_model(ckpt, bilinear)
    dst = os.path.join(work, f"out_{variant}")
    flag = ["--unet_bilinear"] if bilinear else []

    kernels = {"warp_nearest": warp_nearest, "conv3x3": conv3x3, "deconv2x2": deconv2x2,
               "bn_relu_norm": bn_relu_norm}
    for fn in kernels.values():
        fn.launches = 0
    conv3x3.dual_launches = conv3x3.tc_launches = deconv2x2.tc_launches = 0
    warp_nearest.vec_launches = 0
    with recording_k1_grids() as grids:
        stats = predict_cli.process(
            ["--img_dir", frames, "--load", ckpt, "--dst_dir", dst,
             "--req_outputs", "theta,consistency", "--batchsize", str(BATCH),
             "--court_img", COURT_IMG, "--court_poi", COURT_POI] + flag)
    launches = _predict_launches(kernels)
    log(f"predict {variant}: kernel launches in the CLI run: {launches}; K1 grids "
        f"{sorted(set(grids))}; on the tensor cores: K2 {conv3x3.tc_launches} of "
        f"{conv3x3.launches}, K3 {deconv2x2.tc_launches} of {deconv2x2.launches}; K1 on the "
        f"float4 stores: {warp_nearest.vec_launches} of {warp_nearest.launches}")
    if grids != [((720, 1280), (360, 640))] * 2:
        raise AssertionError(f"predict {variant}: K1 did not run once a batch on the sampled "
                             f"360x640 grid of the 1280x720 warp: {grids}")
    if conv3x3.tc_launches != conv3x3.launches or deconv2x2.tc_launches != deconv2x2.launches:
        raise AssertionError(f"predict {variant}: a bf16 K2 or K3 launch left the tensor-core "
                             "route")
    if warp_nearest.vec_launches != warp_nearest.launches:
        raise AssertionError(f"predict {variant}: a K1 launch left the float4 route")
    for name, n in launches.items():
        if n <= 0 and not (bilinear and name == "deconv2x2"):
            raise AssertionError(f"predict {variant}: {name} was never launched by the path")
    if bilinear and launches["deconv2x2"]:
        raise AssertionError("predict bilinear: K3 was launched by the bilinear UNet")
    with open(os.path.join(dst, "game0_court.json")) as f:
        out = json.load(f)
    if out.pop("model") != variant:
        raise AssertionError(f"predict {variant}: wrong model name in the JSON")
    if len(out) != 16:
        raise AssertionError(f"predict {variant}: {len(out)} records, expected 16")
    thetas = np.array([rec["theta"] for rec in out.values()], np.float64)
    scores = np.array([rec["score"] for rec in out.values()], np.float64)
    if thetas.shape != (16, 1, 3, 3) or not np.isfinite(thetas).all() \
            or not np.isfinite(scores).all():
        raise AssertionError(f"predict {variant}: non-finite or misshapen records")
    log(f"predict {variant}: 16 finite records; theta spread {thetas.std(0).max():.3e}, "
        f"scores {scores.min():.4f}..{scores.max():.4f}; CLI loop "
        f"{stats['frames'] / stats['seconds']:.1f} frames/s (host pipeline "
        f"included, 2 batches) [{card}]")

    # f32 parity: CUDA (TF32 off) against the CPU's plain versions
    class Args:
        target_size = unet_size = (640, 360)
        warp_size = court_size = (1280, 720)
        mask_classes = 4
        use_unet = use_resnet = use_warper = True
        unet_uv = False
        unet_bilinear = bilinear
        resnet_name, resnet_input = "resnet34", "img+mask"
        compute_dtype = "float32"
        court_img, court_poi = COURT_IMG, COURT_POI

    ds = BasicDataset(sorted(os.listdir(frames))[:2], frames, (640, 360))
    x = torch.from_numpy(np.stack([ds[i]["image"] for i in range(2)])).float() / 255.0
    res = {}
    for device in ("cuda", "cpu"):
        Args.device = device
        b = build_model(Args, load=ckpt, fold_bn=True)
        n0, t0 = conv3x3.launches, conv3x3.tc_launches
        d0, dt0 = deconv2x2.launches, deconv2x2.tc_launches
        with torch.inference_mode():
            p = b.model.predict(x.to(b.device), b.court_labels, b.value_table)
        res[device] = {k: p[k].float().cpu() for k in ("theta", "consist_score")}
        if device == "cuda":    # f32: every K2 and K3 launch on the SIMT kernels
            launches["conv3x3_f32"] = conv3x3.launches - n0
            launches["deconv2x2_f32"] = deconv2x2.launches - d0
            if launches["conv3x3_f32"] <= 0 or conv3x3.tc_launches != t0:
                raise AssertionError(f"predict {variant} f32: K2 did not run on the SIMT "
                                     "route alone")
            if (launches["deconv2x2_f32"] <= 0) != bilinear or deconv2x2.tc_launches != dt0:
                raise AssertionError(f"predict {variant} f32: K3 did not run on the SIMT "
                                     "route alone")
    d_theta = (res["cuda"]["theta"] - res["cpu"]["theta"]).abs().max().item()
    d_score = (res["cuda"]["consist_score"] - res["cpu"]["consist_score"]).abs().max().item()
    log(f"predict {variant} f32 CUDA vs CPU: theta max abs {d_theta:.3e} (bound 2e-4), "
        f"score max abs {d_score:.3e} (bound 1e-3)")
    if not (d_theta <= 2e-4 and d_score <= 1e-3):
        raise AssertionError(f"predict {variant}: f32 CUDA and CPU disagree beyond the bounds")

    # steady-state device time of the predict path at batch 8 (bf16)
    Args.device, Args.compute_dtype = "cuda", "bfloat16"
    b = build_model(Args, load=ckpt, fold_bn=True)
    xb = torch.from_numpy(np.stack([ds[i % 2]["image"] for i in range(BATCH)])).to(dev)

    def step():
        with torch.inference_mode():
            b.model.predict(xb.float() / 255.0, b.court_labels, b.value_table)

    ms = cuda_ms(step, warmup=2, runs=5)
    log(f"predict {variant}: theta+consistency 640x360 bf16 batch {BATCH}: {ms:.2f} ms/batch, "
        f"{BATCH * 1000.0 / ms:.1f} frames/s (CUDA events, median of 5) [{card}]")
    return launches


FULL_OUTPUTS = "theta,consistency,segm_mask,warp_mask,poi"


def _read_pickle_masks(path):
    """{name: decoded mask} of a pickled PNG-buffer stream (the last record
    of a name wins, as readers keep it)."""
    import pickle

    from sports_field_homography_tpu_torch.data.png import decode_png

    out, n = {}, 0
    with open(path, "rb") as f:
        while True:
            try:
                name, buf = pickle.load(f)
            except EOFError:
                return out, n
            out[name] = decode_png(buf.tobytes())
            n += 1


def phase_predict_full(dev, card, work):
    """The predict CLI with every output but debug (BASELINE config #2 less
    the debug renders, which need cv2) on the predict phase's 16 frames
    and .pth: K1 once a batch on the full 1280x720 grid, records equal to
    the theta+consistency run's, the masks checked against K1's plain
    version and the argmax, --resume, f32 CUDA against the CPU, and the
    device and CLI times."""
    import pickle

    import torch

    from sports_field_homography_tpu_torch.cli import predict as predict_cli
    from sports_field_homography_tpu_torch.cli.engine import build_model, predict_fn
    from sports_field_homography_tpu_torch.data.assets import open_court_template
    from sports_field_homography_tpu_torch.data.dataset import BasicDataset
    from sports_field_homography_tpu_torch.data.png import read_png
    from sports_field_homography_tpu_torch.ops.bn_relu import bn_relu_norm
    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3
    from sports_field_homography_tpu_torch.ops.deconv import deconv2x2
    from sports_field_homography_tpu_torch.ops.resize import resize_nearest
    from sports_field_homography_tpu_torch.ops.warp import (template_value_table, warp_nearest,
                                                           warp_nearest_plain)
    from sports_field_homography_tpu_torch.utils.postprocess import onehot_to_image

    frames = os.path.join(work, "game0")
    ckpt = os.path.join(work, "flagship", "model.pth")
    with open(os.path.join(work, "out_flagship", "game0_court.json")) as f:
        slim = json.load(f)
    names = sorted(n[:-4] for n in os.listdir(frames))
    base = ["--img_dir", frames, "--load", ckpt, "--req_outputs", FULL_OUTPUTS,
            "--batchsize", str(BATCH), "--court_img", COURT_IMG, "--court_poi", COURT_POI,
            "--device", dev.type]
    kernels = {"warp_nearest": warp_nearest, "conv3x3": conv3x3, "deconv2x2": deconv2x2,
               "bn_relu_norm": bn_relu_norm}
    runs = {}
    for fmt, mask_type in (("png", "gray"), ("pickle", "rgb")):
        dst = os.path.join(work, f"out_full_{fmt}")
        for fn in kernels.values():
            fn.launches = 0
        conv3x3.dual_launches = conv3x3.tc_launches = deconv2x2.tc_launches = 0
        warp_nearest.vec_launches = 0
        with recording_k1_grids() as grids:
            stats = predict_cli.process(base + ["--dst_dir", dst, "--mask_save_format", fmt,
                                               "--mask_type", mask_type])
        launches = _predict_launches(kernels)
        log(f"predict full outputs ({fmt}, {mask_type}): kernel launches in the CLI run: "
            f"{launches}; K1 grids {grids}; on the tensor cores: K2 {conv3x3.tc_launches} of "
            f"{conv3x3.launches}, K3 {deconv2x2.tc_launches} of {deconv2x2.launches}; K1 on "
            f"the float4 stores: {warp_nearest.vec_launches} of {warp_nearest.launches}")
        if grids != [((720, 1280), None)] * 2 or warp_nearest.launches != 2:
            raise AssertionError(f"predict full outputs: K1 did not run once a batch on the "
                                 f"full 1280x720 grid alone: {grids}")
        if conv3x3.tc_launches != conv3x3.launches or deconv2x2.tc_launches != \
                deconv2x2.launches or warp_nearest.vec_launches != warp_nearest.launches:
            raise AssertionError("predict full outputs: a K1, K2 or K3 launch left its fast "
                                 "route")
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"predict full outputs: {name} was never launched")
        with open(os.path.join(dst, "game0_court.json")) as f:
            out = json.load(f)
        if out.pop("model") != "flagship" or sorted(out) != names:
            raise AssertionError("predict full outputs: wrong frames or model in the JSON")
        slim_pairs = [(slim[n]["theta"], slim[n]["score"]) for n in names]
        if [(out[n]["theta"], out[n]["score"]) for n in names] != slim_pairs:
            raise AssertionError("predict full outputs: theta or score differ from the "
                                 "theta+consistency run")
        if any(list(out[n]) != ["score", "theta", "poi"] for n in names):
            raise AssertionError("predict full outputs: record keys not in the JAX CLI's order")
        poi = np.array([out[n]["poi"] for n in names], np.float64)
        if poi.ndim != 3 or poi.shape[0] != 16 or poi.shape[2] != 2 \
                or not np.isfinite(poi).all():
            raise AssertionError(f"predict full outputs: poi {poi.shape} not finite (16, N, 2)")
        masks = {}
        for key in ("segm_mask", "warp_mask"):
            sub = os.path.join(dst, "court", key)
            if fmt == "png":
                masks[key] = {n: read_png(os.path.join(sub, n + ".png")) for n in names}
            else:
                masks[key], n_rec = _read_pickle_masks(os.path.join(sub, "data.pkl"))
                if n_rec != 16:
                    raise AssertionError(f"predict full outputs: {n_rec} pickle records in "
                                         f"{key}, expected 16")
            want = (720, 1280) + ((3,) if mask_type == "rgb" else ())
            if sorted(masks[key]) != names or any(m.shape != want for m in masks[key].values()):
                raise AssertionError(f"predict full outputs: {key} masks missing or misshapen")
        runs[fmt] = (stats, out, masks, launches, dst)
        log(f"predict full outputs ({fmt}, {mask_type}): 16 records, theta and score equal to "
            f"the theta+consistency run's, poi {poi.shape} finite; 16 + 16 masks decoded; CLI "
            f"{stats['frames'] / stats['seconds']:.1f} frames/s over {stats['seconds']:.3f} s "
            f"(2 batches, host pipeline included), writer thread busy "
            f"{stats['writer_seconds']:.3f} s = {stats['writer_seconds'] / stats['seconds']:.1%}"
            f" of the loop [{card}]")
    stats, out, masks, launches, dst = runs["png"]
    # the RGB run's masks are the gray run's through the palette (the file
    # holds RGB: the BGR palette reversed)
    for key in ("segm_mask", "warp_mask"):
        rgb = runs["pickle"][2][key]
        for n in names:
            if not np.array_equal(rgb[n], onehot_to_image(masks[key][n], 4)[0][..., ::-1]):
                raise AssertionError(f"predict full outputs: rgb {key} of {n} is not the "
                                     "gray one's palette")

    # frame 0's warp mask: K1's plain version on the CPU at its JSON theta
    labels_np = open_court_template(COURT_IMG, 4, size=(1280, 720))
    cpu_labels, values = torch.from_numpy(labels_np), template_value_table(labels_np, 4)
    theta0 = torch.tensor(out[names[0]]["theta"], dtype=torch.float32)
    plain = (warp_nearest_plain(cpu_labels, theta0[None], (720, 1280), values) * 4).to(torch.uint8)
    n_diff = int((plain[0].numpy() != masks["warp_mask"][names[0]]).sum())
    if n_diff:
        raise AssertionError(f"predict full outputs: frame 0's warp mask differs from K1's "
                             f"plain version on {n_diff} pixels")
    # the segm masks: the nearest resize (cv2's rule, host) of the uint8
    # argmax of the same program's logits
    b = build_model(_full_args("cuda", "bfloat16"), load=ckpt, fold_bn=True)
    ds = BasicDataset(sorted(os.listdir(frames)), frames, b.config.target_size)
    xb = torch.from_numpy(np.stack([ds[i]["image"] for i in range(BATCH)])).to(dev)
    with torch.inference_mode():
        segm = predict_fn(b, True, ["segm_mask"])(xb)["segm_mask"].cpu().numpy()
    resized = predict_cli._resize_masks(segm, (1280, 720))
    n_diff = sum(int((resized[i] != masks["segm_mask"][names[i]]).sum()) for i in range(BATCH))
    if n_diff:
        raise AssertionError(f"predict full outputs: segm masks differ from the resized "
                             f"argmax on {n_diff} pixels")
    # one batch: the full-grid labels' nearest downsample equals K1 on the
    # sampled grid, bit for bit
    theta = torch.tensor([out[n]["theta"] for n in names[:BATCH]], device=dev)
    full = warp_nearest(b.court_labels, theta, (720, 1280), b.value_table) * 4
    sampled = warp_nearest(b.court_labels, theta, (720, 1280), b.value_table, (360, 640)) * 4
    if not torch.equal(resize_nearest(full, (360, 640)), sampled):
        raise AssertionError("predict full outputs: the downsampled full-grid labels differ "
                             "from the sampled-grid labels")
    log("predict full outputs: frame 0's warp mask equals K1's plain version on the CPU at "
        "its JSON theta on all 921600 pixels; the segm masks equal the resized argmax; on the "
        "card the nearest downsample of a batch's full-grid labels equals the sampled-grid "
        "labels bit for bit")

    # --resume from the pickle run: the first 8 records and a torn line,
    # the mask streams cut in the middle of a record
    rdst = os.path.join(work, "out_full_resume")
    pdst = runs["pickle"][4]
    with open(os.path.join(pdst, "game0_court.json")) as f:
        pfull = json.load(f)
    os.makedirs(rdst)
    with open(os.path.join(rdst, "game0_court_processing.json"), "w") as f:
        for n in names[:8]:
            f.write(json.dumps({n: pfull[n]}) + "\n")
        f.write('{"' + names[8] + '": {"score": 0.1')
    for key in ("segm_mask", "warp_mask"):
        os.makedirs(os.path.join(rdst, "court", key))
        with open(os.path.join(pdst, "court", key, "data.pkl"), "rb") as f:
            ends = []
            for _ in range(10):
                pickle.load(f)
                ends.append(f.tell())
            f.seek(0)
            stream = f.read()
        with open(os.path.join(rdst, "court", key, "data.pkl"), "wb") as f:
            # the first 9 records whole (a crash writes masks before their
            # record), the tenth cut in the middle
            f.write(stream[: (ends[8] + ends[9]) // 2])
    rstats = predict_cli.process(base + ["--dst_dir", rdst, "--mask_save_format", "pickle",
                                         "--mask_type", "rgb", "--resume"])
    with open(os.path.join(rdst, "game0_court.json")) as f:
        resumed = json.load(f)
    if rstats["frames"] != 8 or resumed != pfull:
        raise AssertionError(f"predict --resume: {rstats['frames']} frames predicted "
                             "(expected 8), or the merged JSON differs from the full run's")
    for key in ("segm_mask", "warp_mask"):
        got, _ = _read_pickle_masks(os.path.join(rdst, "court", key, "data.pkl"))
        if sorted(got) != names or any(not np.array_equal(got[n], runs["pickle"][2][key][n])
                                       for n in names):
            raise AssertionError(f"predict --resume: the {key} stream does not hold the full "
                                 "run's masks")
    log("predict --resume: 8 frames predicted after 8 recorded and a torn record; merged "
        "game0_court.json equal to the uninterrupted run's; both pickle streams read to their "
        "end with every frame's mask equal")

    # f32: CUDA (TF32 off) against the CPU on 2 frames of the full program
    x2 = torch.from_numpy(np.stack([ds[i]["image"] for i in range(2)]))
    keep = ["theta", "consist_score", "poi", "warp_mask", "segm_mask"]
    res = {}
    for device in ("cuda", "cpu"):
        bb = build_model(_full_args(device, "float32"), load=ckpt, fold_bn=True)
        with torch.inference_mode():
            res[device] = {k: v.cpu() for k, v in predict_fn(bb, True, keep)(
                x2.to(bb.device)).items()}
    d = {k: (res["cuda"][k].float() - res["cpu"][k].float()).abs().max().item()
         for k in ("theta", "consist_score", "poi")}
    warp_frac = (res["cuda"]["warp_mask"] != res["cpu"]["warp_mask"]).float().mean().item()
    segm_frac = (res["cuda"]["segm_mask"] != res["cpu"]["segm_mask"]).float().mean().item()
    log(f"predict full outputs f32 CUDA vs CPU: theta max abs {d['theta']:.3e} (bound 2e-4), "
        f"score {d['consist_score']:.3e} (1e-3), poi {d['poi']:.3e} (5e-4), warp labels differ "
        f"on {warp_frac:.3e} of pixels (< 1e-3), segm labels on {segm_frac:.3e}")
    if not (d["theta"] <= 2e-4 and d["consist_score"] <= 1e-3 and d["poi"] <= 5e-4
            and warp_frac < 1e-3):
        raise AssertionError("predict full outputs: f32 CUDA and CPU disagree beyond the bounds")

    # device time of a batch of 8, D2H into pinned memory included: the
    # full-output program beside the theta+consistency one
    full_fn = predict_fn(b, True, keep)
    slim_fn = predict_fn(b, True, ["theta", "consist_score"])

    def timed(fn):
        def step():
            with torch.inference_mode():
                predict_cli._to_host(fn(xb), dev)
        return cuda_ms(step, warmup=2, runs=7)

    ms = {"slim": timed(slim_fn), "full": timed(full_fn)}
    ms["slim2"], ms["full2"] = timed(slim_fn), timed(full_fn)
    with torch.inference_mode():
        d2h = sum(v.numel() * v.element_size() for v in full_fn(xb).values())
    log(f"predict full outputs 640x360 bf16 batch {BATCH}: {ms['full']:.2f} / {ms['full2']:.2f} "
        f"ms/batch with {d2h / 1e6:.2f} MB copied to pinned host memory, theta+consistency "
        f"{ms['slim']:.2f} / {ms['slim2']:.2f} ms/batch (CUDA events, median of 7, two turns "
        f"each, D2H included) [{card}]")
    # the CLI's rate over 8 batches (the 16 frames 4 times), beside the
    # theta+consistency CLI's on the same frames
    many = os.path.join(work, "game0_x4")
    os.makedirs(many)
    for i in range(64):
        os.symlink(os.path.join(frames, f"{i % 16:06d}.png"), os.path.join(many, f"{i:06d}.png"))
    common = ["--img_dir", many, "--load", ckpt, "--batchsize", str(BATCH), "--court_img",
              COURT_IMG, "--court_poi", COURT_POI, "--device", dev.type]
    for tag, extra in (("theta+consistency", ["--req_outputs", "theta,consistency"]),
                       ("png gray", ["--req_outputs", FULL_OUTPUTS, "--mask_type", "gray",
                                     "--mask_save_format", "png"]),
                       ("pickle rgb", ["--req_outputs", FULL_OUTPUTS, "--mask_type", "rgb",
                                       "--mask_save_format", "pickle"])):
        dst = os.path.join(work, "out_x4_" + tag.split()[0].replace("+", "_"))
        st = predict_cli.process(common + extra + ["--dst_dir", dst])
        log(f"predict CLI {tag}, 64 frames (8 batches): {st['frames'] / st['seconds']:.1f} "
            f"frames/s; writer thread busy {st['writer_seconds']:.3f} of {st['seconds']:.3f} s "
            f"({st['writer_seconds'] / st['seconds']:.1%}), "
            f"{st['writer_seconds'] * 1e3 / st['frames']:.2f} ms a frame [{card}]")
    return launches


def _full_args(device, dtype):
    """build_model arguments of the flagship at the predict CLI's defaults
    with the full outputs (1280x720 warp and court)."""
    class Args:
        target_size = unet_size = (640, 360)
        warp_size = court_size = (1280, 720)
        mask_classes = 4
        use_unet = use_resnet = use_warper = True
        unet_uv = unet_bilinear = False
        resnet_name, resnet_input = "resnet34", "img+mask"
        court_img, court_poi = COURT_IMG, COURT_POI

    Args.device, Args.compute_dtype = device, dtype
    return Args


def _rel_l2(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def _reduction(name, got, ref, limit):
    """rel-L2 of a reduction's result against its reference, <= limit."""
    rel = _rel_l2(got, ref)
    if not rel <= limit:
        raise AssertionError(f"{name}: rel-L2 {rel:.3e} against the plain version "
                             f"exceeds {limit:.0e}")
    return rel


def _repeats_bitwise(name, fn):
    """Run a reduction kernel twice on the same inputs: equal bit for bit."""
    import torch

    a, b = fn(), fn()
    torch.cuda.synchronize()
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{name}: two runs on the same input differ")
    return "bitwise repeat: equal"


def phase_train_kernels(dev, card):
    """K2+stats, K5, K7-bwd and K3-bwd against their plain versions at the
    train path's shapes (batch 8)."""
    import torch
    import torch.nn.functional as F

    from sports_field_homography_tpu_torch.ops.bn_relu_bwd import (
        bn_relu_bwd, bn_relu_bwd_plain)
    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain
    from sports_field_homography_tpu_torch.ops.deconv import (
        deconv2x2_backward, deconv2x2_backward_plain)
    from sports_field_homography_tpu_torch.ops.wgrad3x3 import wgrad3x3, wgrad3x3_plain

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(1)
    results = {}

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def prologue(c):
        return (rnd(c, scale=0.1), torch.rand((c,), generator=gen, device=dev) + 0.5,
                rnd(c, scale=0.1))

    def as64(t):
        return None if t is None else (tuple(v.double() for v in t)
                                       if isinstance(t, tuple) else t.double())

    # --- K2 with the stats epilogue ----------------------------------------
    err, timing = 0.0, None
    for (h, w, cin, cout, pro_on) in ((360, 640, 64, 64, True), (45, 80, 1024, 512, False)):
        x = rnd(BATCH, h, w, cin)
        wt = rnd(3, 3, cin, cout, scale=1.0 / (3.0 * cin ** 0.5))
        b = rnd(cout, scale=0.1)
        pro = prologue(cin) if pro_on else None
        tag = f"{cin}->{cout} at {h}x{w}{' +prologue' if pro_on else ''}"
        y, s = routed(conv3x3, False, lambda: conv3x3(x, wt, b, pro, stats=True))
        y_ref, _ = conv3x3_plain(x, wt, b, pro, stats=True)
        _, s64 = conv3x3_plain(x.double(), wt.double(), b.double(), as64(pro), stats=True)
        e = _compare(f"K2+stats f32 {tag}", y, y_ref, 1e-4, 1e-4)
        r = _reduction(f"K2+stats f32 sums {tag}", s, s64, 1e-5)
        xb, wb = x.bfloat16(), wt.bfloat16()
        yb, sb = routed(conv3x3, True, lambda: conv3x3(xb, wb, b, pro, stats=True))
        yb_ref, sb_ref = conv3x3_plain(xb, wb, b, pro, stats=True)
        eb = _compare(f"K2+stats bf16 {tag}", yb, yb_ref, 2e-2, 2e-2)
        rb = _reduction(f"K2+stats bf16 sums {tag}", sb, sb_ref, 1e-3)
        rep = _repeats_bitwise(f"K2+stats {tag}", lambda: conv3x3(xb, wb, b, pro, stats=True))
        ms = cuda_ms(lambda: conv3x3(xb, wb, b, pro, stats=True))
        pms = cuda_ms(lambda: conv3x3_plain(xb, wb, b, pro, stats=True))
        log(f"K2+stats conv3x3 {tag}: f32 (SIMT) max abs err {e:.2e}, sums rel-L2 {r:.2e} "
            f"(vs float64); bf16 (tensor cores) max abs err {eb:.2e}, sums rel-L2 {rb:.2e}; "
            f"{rep}; bf16 kernel {ms:.3f} ms, plain (f32 cuDNN conv + sums) {pms:.3f} ms "
            f"[{card}]")
        err = max(err, e, eb)
        timing = timing or (ms, pms)
        del x, y, y_ref, xb, yb, yb_ref
    results["conv3x3_stats"] = (err, *timing)

    # --- K5 wgrad ----------------------------------------------------------
    err, timing = 0.0, None
    for (h, w, cin, cout, pro_on) in ((360, 640, 64, 64, False), (360, 640, 64, 64, True),
                                      (180, 320, 128, 128, False), (45, 80, 1024, 512, False)):
        x = rnd(BATCH, h, w, cin)
        dy = rnd(BATCH, h, w, cout)
        pro = prologue(cin) if pro_on else None
        tag = f"{cin}->{cout} at {h}x{w}{' +prologue' if pro_on else ''}"
        dw, db = routed(wgrad3x3, False, lambda: wgrad3x3(x, dy, pro))
        dw64, db64 = wgrad3x3_plain(x.double(), dy.double(), as64(pro))
        r = max(_reduction(f"K5 f32 dW {tag}", dw, dw64, 1e-5),
                _reduction(f"K5 f32 db {tag}", db, db64, 1e-5))
        r_plain = _rel_l2(wgrad3x3_plain(x, dy, pro)[0], dw64)
        xb, dyb = x.bfloat16(), dy.bfloat16()
        dwb, dbb = routed(wgrad3x3, True, lambda: wgrad3x3(xb, dyb, pro))
        dwb_ref, dbb_ref = wgrad3x3_plain(xb, dyb, pro)
        rb = max(_reduction(f"K5 bf16 dW {tag}", dwb, dwb_ref, 1e-3),
                 _reduction(f"K5 bf16 db {tag}", dbb, dbb_ref, 1e-3))
        e = max(float((dw - dw64).abs().max()), float((dwb - dwb_ref).abs().max()))
        rep = _repeats_bitwise(f"K5 {tag}", lambda: wgrad3x3(xb, dyb, pro))
        ms = cuda_ms(lambda: wgrad3x3(xb, dyb, pro))
        pms = cuda_ms(lambda: wgrad3x3_plain(xb, dyb, pro))
        log(f"K5 wgrad3x3 {tag}: f32 (SIMT) rel-L2 {r:.2e} vs float64 (plain f32 cuDNN "
            f"{r_plain:.2e}); bf16 (tensor cores) rel-L2 {rb:.2e}; {rep}; bf16 kernel "
            f"{ms:.3f} ms, plain (cuDNN wgrad) {pms:.3f} ms [{card}]")
        err = max(err, e)
        if timing is None:      # the line's case: no prologue, as the library call
            ms32 = cuda_ms(lambda: wgrad3x3(x, dy, pro))
            pms32 = cuda_ms(lambda: wgrad3x3_plain(x, dy, pro))
            bnd32 = bound(2.0 * BATCH * h * w * 9 * cin * cout, nbytes(x, dy, dw, db), PEAK_F32)
            log(f"K5 wgrad3x3 f32 (SIMT) {tag}: kernel {ms32:.3f} ms, plain and library "
                f"(torch.nn.grad.conv2d_weight f32, TF32 off) {pms32:.3f} ms; bound "
                f"{bnd32[0]:.3f} ms ({bnd32[1]}) [{card}]")
            results["wgrad3x3_f32"] = entry(float((dw - dw64).abs().max()), ms32, pms32,
                                            pms32, bnd32)
            lib = cuda_ms(lambda: torch.nn.grad.conv2d_weight(
                nchw(xb), (cout, cin, 3, 3), nchw(dyb), padding=1))
            bnd = bound(2.0 * BATCH * h * w * 9 * cin * cout,
                        nbytes(xb, dyb, dwb, dbb))
            log(f"K5 library torch.nn.grad.conv2d_weight (bf16) {tag}: {lib:.3f} ms; "
                f"bound {bnd[0]:.3f} ms ({bnd[1]}) [{card}]")
            timing = (ms, pms, lib, bnd)
        del x, dy, xb, dyb
    results["wgrad3x3"] = entry(err, *timing)

    # --- K7-bwd ------------------------------------------------------------
    c = 64
    y = rnd(BATCH, 360, 640, c, scale=2.0) + 0.3
    g = rnd(BATCH, 360, 640, c)
    mean = y.mean(dim=(0, 1, 2))
    rstd = torch.rsqrt((y * y).mean(dim=(0, 1, 2)) - mean * mean + 1e-5)
    gamma = torch.rand((c,), generator=gen, device=dev) + 0.5
    beta = rnd(c, scale=0.3)
    vecs = (mean, rstd, gamma, beta)
    dx, dgam, dbet = vec_routed(bn_relu_bwd, lambda: bn_relu_bwd(y, g, *vecs))
    dx_ref, _, _ = bn_relu_bwd_plain(y, g, *vecs)
    _, dgam64, dbet64 = bn_relu_bwd_plain(y.double(), g.double(), *map(lambda v: v.double(), vecs))
    e = _compare("K7-bwd f32 dx", dx, dx_ref, 1e-4, 1e-4)
    r = max(_reduction("K7-bwd f32 dgamma", dgam, dgam64, 1e-5),
            _reduction("K7-bwd f32 dbeta", dbet, dbet64, 1e-5))
    ms32 = cuda_ms(lambda: bn_relu_bwd(y, g, *vecs))
    del dgam64, dbet64
    yb, gb = y.bfloat16(), g.bfloat16()
    dxb, dgamb, dbetb = vec_routed(bn_relu_bwd, lambda: bn_relu_bwd(yb, gb, *vecs))
    dxb_ref, dgamb_ref, dbetb_ref = bn_relu_bwd_plain(yb, gb, *vecs)
    eb = _compare("K7-bwd bf16 dx", dxb, dxb_ref, 2e-2, 2e-2)
    rb = max(_reduction("K7-bwd bf16 dgamma", dgamb, dgamb_ref, 1e-3),
             _reduction("K7-bwd bf16 dbeta", dbetb, dbetb_ref, 1e-3))
    rep = _repeats_bitwise("K7-bwd", lambda: bn_relu_bwd(yb, gb, *vecs))
    ms = cuda_ms(lambda: bn_relu_bwd(yb, gb, *vecs))
    bare = graph_ms(lambda: bn_relu_bwd(yb, gb, *vecs), n=10)
    pms = cuda_ms(lambda: bn_relu_bwd_plain(yb, gb, *vecs))
    # yardstick: the autograd of relu(F.batch_norm(training=True)) on the
    # same bf16 input (its forward made beforehand, not timed)
    yl = nchw(yb).detach().requires_grad_()
    gl, bl = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
    out = torch.relu(F.batch_norm(yl, None, None, gl, bl, training=True, eps=1e-5))
    gn = nchw(gb)
    lib = cuda_ms(lambda: torch.autograd.grad(out, (yl, gl, bl), gn, retain_graph=True))
    bnd = bound(0, nbytes(yb, gb, dxb))
    floor = nbytes(yb, gb, yb, gb, dxb) / HBM * 1e3     # two passes: y and g read twice
    log(f"K7-bwd bn_relu_bwd 360x640x{c}: f32 dx max abs err {e:.2e}, sums rel-L2 "
        f"{r:.2e} (vs float64); bf16 dx max abs err {eb:.2e}, sums rel-L2 {rb:.2e}; "
        f"{rep}; 16-byte route, 3 launches a call; bf16 kernel {ms:.3f} ms timed whole, "
        f"{bare:.3f} ms bare (CUDA graph of 10); f32 kernel {ms32:.3f} ms; plain (torch "
        f"elementwise + sums) {pms:.3f} ms, library (autograd of F.batch_norm + ReLU) "
        f"{lib:.3f} ms; bound {bnd[0]:.3f} ms ({bnd[1]}), two-pass floor {floor:.3f} ms; "
        f"bare / two-pass floor {bare / floor:.2f} [{card}]")
    results["bn_relu_bwd"] = entry(max(e, eb), ms, pms, lib, bnd)
    del out, yl, gn
    del y, g, dx, dx_ref, yb, gb, dxb, dxb_ref

    # --- K3-bwd at the four up-convs: f32 on the SIMT kernels, bf16 on the
    # tensor cores (timed per level in phase_levels) -------------------------
    err32, ms32, pms32, lib32, flops, n_bytes = 0.0, 0.0, 0.0, 0.0, 0.0, 0
    for tag, h, w, cin in K3_LEVELS:
        cout = cin // 2
        x = rnd(BATCH, h, w, cin)
        dy = rnd(BATCH, 2 * h, 2 * w, cout)
        wt = rnd(cin, 2, 2, cout, scale=cin ** -0.5)
        dx, dw, db = routed(deconv2x2_backward, False, lambda: deconv2x2_backward(x, dy, wt))
        dx_ref, _, _ = deconv2x2_backward_plain(x, dy, wt)
        _, dw64, db64 = deconv2x2_backward_plain(x.double(), dy.double(), wt.double())
        e = _compare(f"K3-bwd f32 dx {tag}", dx, dx_ref, 1e-4, 1e-4)
        r = max(_reduction(f"K3-bwd f32 dW {tag}", dw, dw64, 1e-5),
                _reduction(f"K3-bwd f32 db {tag}", db, db64, 1e-5))
        del dw64, db64
        rep = _repeats_bitwise(f"K3-bwd f32 {tag}", lambda: deconv2x2_backward(x, dy, wt))
        xb, dyb, wb = x.bfloat16(), dy.bfloat16(), wt.bfloat16()
        dxb, dwb, dbb = routed(deconv2x2_backward, True, lambda: deconv2x2_backward(xb, dyb, wb))
        dxb_ref, dwb_ref, dbb_ref = deconv2x2_backward_plain(xb, dyb, wb)
        eb = _compare(f"K3-bwd bf16 dx {tag}", dxb, dxb_ref, 2e-2, 2e-2)
        rb = max(_reduction(f"K3-bwd bf16 dW {tag}", dwb, dwb_ref, 1e-3),
                 _reduction(f"K3-bwd bf16 db {tag}", dbb, dbb_ref, 1e-3))
        _repeats_bitwise(f"K3-bwd bf16 {tag}", lambda: deconv2x2_backward(xb, dyb, wb))
        ms = cuda_ms(lambda: deconv2x2_backward(x, dy, wt))
        pms = cuda_ms(lambda: deconv2x2_backward_plain(x, dy, wt))
        # yardstick: the autograd of F.conv_transpose2d in f32 (forward not timed)
        xl = nchw(x).detach().requires_grad_()
        wl = wt.permute(0, 3, 1, 2).contiguous().requires_grad_()
        bl = torch.zeros(cout, device=dev, requires_grad=True)
        out = F.conv_transpose2d(xl, wl, bl, stride=2)
        dyn = nchw(dy)
        lib = cuda_ms(lambda: torch.autograd.grad(out, (xl, wl, bl), dyn, retain_graph=True))
        log(f"K3-bwd deconv2x2_backward {tag}: f32 (SIMT) dx max abs err {e:.2e}, dW/db rel-L2 "
            f"{r:.2e} (vs float64); bf16 (tensor cores) dx max abs err {eb:.2e}, dW/db rel-L2 "
            f"{rb:.2e}; {rep} (both routes); f32 kernel {ms:.3f} ms, plain (cuDNN dgrad + "
            f"einsum, f32) {pms:.3f} ms, library (autograd of F.conv_transpose2d, f32) "
            f"{lib:.3f} ms [{card}]")
        err32 = max(err32, e)
        ms32, pms32, lib32 = ms32 + ms, pms32 + pms, lib32 + lib
        flops += 2 * 2.0 * BATCH * h * w * cin * 4 * cout
        n_bytes += nbytes(x, dy, wt, dx, dw, db)
        del x, dy, dx, dx_ref, xb, dyb, dxb, dxb_ref, out, xl, dyn
    bnd = bound(flops, n_bytes, PEAK_F32)
    log(f"K3-bwd f32 (SIMT) all four up-convs: kernel {ms32:.3f} ms, plain {pms32:.3f} ms, "
        f"library {lib32:.3f} ms; bound {bnd[0]:.3f} ms ({bnd[1]}) [{card}]")
    results["deconv2x2_backward_f32"] = entry(err32, ms32, pms32, lib32, bnd)
    return results


def phase_fwd_kernels(dev, card):
    """K7-fwd (stats, norm) and K2's two-input form against their plain
    versions at the new paths' shapes (batch 8)."""
    import torch
    import torch.nn.functional as F

    from sports_field_homography_tpu_torch.ops.bn_relu import (
        bn_relu_norm, bn_relu_norm_plain, bn_relu_stats, bn_relu_stats_plain)
    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(2)
    results = {}

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    # --- K7-fwd stats: the stem's f32 conv output, and bf16 ---------------
    c = 64
    x = rnd(BATCH, 360, 640, c, scale=2.0) + 0.5
    s = bn_relu_stats(x)
    r = _reduction("K7-fwd stats f32", s, bn_relu_stats_plain(x.double()), 1e-5)
    xb = x.bfloat16()
    rb = _reduction("K7-fwd stats bf16", bn_relu_stats(xb), bn_relu_stats_plain(xb), 1e-3)
    rep = (_repeats_bitwise("K7-fwd stats f32", lambda: bn_relu_stats(x)),
           _repeats_bitwise("K7-fwd stats bf16", lambda: bn_relu_stats(xb)))[0]
    ms = cuda_ms(lambda: bn_relu_stats(x))
    pms = cuda_ms(lambda: bn_relu_stats_plain(x))
    lib = cuda_ms(lambda: torch.var_mean(x, dim=(0, 1, 2), correction=0))
    bnd = bound(2.0 * x.numel(), nbytes(x, s), PEAK_F32)
    e = float((s.double() - bn_relu_stats_plain(x.double())).abs().max())
    log(f"K7-fwd bn_relu_stats 360x640x{c}: f32 rel-L2 {r:.2e} vs float64, bf16 rel-L2 "
        f"{rb:.2e}; {rep}; f32 kernel {ms:.3f} ms (bf16 "
        f"{cuda_ms(lambda: bn_relu_stats(xb)):.3f} ms), plain (torch sums) {pms:.3f} ms, "
        f"library torch.var_mean {lib:.3f} ms; bound {bnd[0]:.3f} ms ({bnd[1]}) [{card}]")
    results["bn_relu_stats"] = entry(e, ms, pms, lib, bnd)

    # --- K7-fwd norm: f32 bit for bit, bf16 ---------------------------------
    mean, var = x.mean(dim=(0, 1, 2)), x.var(dim=(0, 1, 2), unbiased=False)
    gamma, beta = torch.rand((c,), generator=gen, device=dev) + 0.5, rnd(c, scale=0.3)
    inv = torch.rsqrt(var + 1e-5) * gamma
    y = bn_relu_norm(x, mean, inv, beta)
    if not torch.equal(y, bn_relu_norm_plain(x, mean, inv, beta)):
        raise AssertionError("K7-fwd norm f32: kernel and plain version differ")
    yb = bn_relu_norm(xb, mean, inv, beta)
    eb = _compare("K7-fwd norm bf16", yb, bn_relu_norm_plain(xb, mean, inv, beta), 2e-2, 2e-2)
    same = torch.equal(yb, bn_relu_norm_plain(xb, mean, inv, beta))
    ms = cuda_ms(lambda: bn_relu_norm(xb, mean, inv, beta))
    pms = cuda_ms(lambda: bn_relu_norm_plain(xb, mean, inv, beta))
    xn = nchw(xb)
    lib = cuda_ms(lambda: torch.relu_(F.batch_norm(xn, None, None, gamma, beta,
                                                   training=True, eps=1e-5)))
    bnd = bound(4.0 * xb.numel(), nbytes(xb, yb), PEAK_F32)
    log(f"K7-fwd bn_relu_norm 360x640x{c}: f32 equal to the plain version bit for bit; bf16 "
        f"max abs err {eb:.2e} (bitwise equal: {same}); bf16 kernel {ms:.3f} ms, plain "
        f"(torch f32 elementwise) {pms:.3f} ms, library F.batch_norm(training=True) + "
        f"ReLU {lib:.3f} ms; bound {bnd[0]:.3f} ms ({bnd[1]}) [{card}]")
    results["bn_relu_norm"] = entry(eb, ms, pms, lib, bnd)
    del x, xb, y, yb, xn

    # --- K2 two-input: up4 conv1 (64 + 64 -> 64 at 360x640) and the
    # bilinear up1 conv1 (512 + 512 -> 512 at 45x80) --------------------------
    err, line = 0.0, None
    for (h, w, ca, cout) in ((360, 640, 64, 64), (45, 80, 512, 512)):
        a, b = rnd(BATCH, h, w, ca), rnd(BATCH, h, w, ca)
        wa = rnd(3, 3, ca, cout, scale=1.0 / (3.0 * (2 * ca) ** 0.5))
        wb = rnd(3, 3, ca, cout, scale=1.0 / (3.0 * (2 * ca) ** 0.5))
        bias = rnd(cout, scale=0.1)
        tag = f"{ca}+{ca}->{cout} at {h}x{w}"
        y, st = routed(conv3x3, False, lambda: conv3x3(a, wa, bias, stats=True, x2=b, w2=wb))
        e = _compare(f"K2 two-input f32 {tag}", y,
                     conv3x3_plain(a, wa, bias, x2=b, w2=wb), 1e-4, 1e-4)
        _, s64 = conv3x3_plain(a.double(), wa.double(), bias.double(), stats=True,
                               x2=b.double(), w2=wb.double())
        r = _reduction(f"K2 two-input f32 sums {tag}", st, s64, 1e-5)
        ab, bb, wab, wbb = a.bfloat16(), b.bfloat16(), wa.bfloat16(), wb.bfloat16()
        yb, sb = routed(conv3x3, True,
                        lambda: conv3x3(ab, wab, bias, stats=True, x2=bb, w2=wbb))
        yb_ref, sb_ref = conv3x3_plain(ab, wab, bias, stats=True, x2=bb, w2=wbb)
        eb = _compare(f"K2 two-input bf16 {tag}", yb, yb_ref, 2e-2, 2e-2)
        rb = _reduction(f"K2 two-input bf16 sums {tag}", sb, sb_ref, 1e-3)
        rep = _repeats_bitwise(f"K2 two-input {tag}",
                               lambda: conv3x3(ab, wab, bias, stats=True, x2=bb, w2=wbb))
        ms = cuda_ms(lambda: conv3x3(ab, wab, bias, x2=bb, w2=wbb))
        ms_s = cuda_ms(lambda: conv3x3(ab, wab, bias, stats=True, x2=bb, w2=wbb))
        pms = cuda_ms(lambda: conv3x3_plain(ab, wab, bias, x2=bb, w2=wbb))
        cat_in = torch.cat([nchw(ab), nchw(bb)], dim=1).contiguous(
            memory_format=torch.channels_last)
        wcat = oihw(torch.cat([wab, wbb], dim=2))
        lib = cuda_ms(lambda: F.conv2d(cat_in, wcat, bias.bfloat16(), padding=1))
        bnd = bound(2.0 * BATCH * h * w * 9 * 2 * ca * cout, nbytes(ab, bb, wab, wbb, yb))
        log(f"K2 two-input conv3x3 {tag}: f32 max abs err {e:.2e}, sums rel-L2 {r:.2e} (vs "
            f"float64); bf16 max abs err {eb:.2e}, sums rel-L2 {rb:.2e}; {rep}; bf16 kernel "
            f"{ms:.3f} ms ({ms_s:.3f} ms with stats), plain (concat + cuDNN) {pms:.3f} ms, "
            f"library F.conv2d on the concat {lib:.3f} ms; bound {bnd[0]:.3f} ms "
            f"({bnd[1]}) [{card}]")
        err = max(err, e, eb)
        line = line or (ms, pms, lib, bnd)
        del a, b, y, yb, yb_ref, ab, bb, cat_in
    results["conv3x3_dual"] = entry(err, *line)
    return results


# bf16 shapes of K2 and K5 on the UNet's levels at 640x360, batch 8:
# (tag, H, W, Cin, Cin2, Cout, prologue, stats, dgrad)
K2_LEVELS = (("64->64", 360, 640, 64, 0, 64, False, False, False),
             ("64->64 +prologue", 360, 640, 64, 0, 64, True, False, False),
             ("64->64 +prologue +stats", 360, 640, 64, 0, 64, True, True, False),
             ("128->128", 180, 320, 128, 0, 128, False, False, False),
             ("512->512", 45, 80, 512, 0, 512, False, False, False),
             ("1024->1024", 22, 40, 1024, 0, 1024, False, False, False),
             ("64+64->64", 360, 640, 64, 64, 64, False, False, False),
             ("512+512->512", 45, 80, 512, 512, 512, False, False, False),
             ("dgrad 1024->512", 45, 80, 1024, 0, 512, False, False, True))
K5_LEVELS = (("64->64", 360, 640, 64, 64, False), ("64->64 +prologue", 360, 640, 64, 64, True),
             ("128->128", 180, 320, 128, 128, False), ("512->512", 45, 80, 512, 512, False),
             ("1024->1024", 22, 40, 1024, 1024, False), ("1024->512", 45, 80, 1024, 512, False))
# the UNet's four up-convs (K3, K3-bwd) at 640x360: (tag, H, W, Cin), Cout = Cin / 2
K3_LEVELS = (("up1 1024->512", 22, 40, 1024), ("up2 512->256", 45, 80, 512),
             ("up3 256->128", 90, 160, 256), ("up4 128->64", 180, 320, 128))
# K7-bwd at each UNet level at 640x360: (H, W, C)
K7_LEVELS = ((360, 640, 64), (180, 320, 128), (90, 160, 256), (45, 80, 512), (22, 40, 1024))


def phase_levels(dev, card):
    """The tensor-core K2, K5, K3 and K3-bwd, and K7-bwd on its 16-byte
    route, at each UNet level's bf16 shape (batch 8): each against its plain
    version, timed beside one library call (for K2 ``F.conv2d``
    channels_last on the same operands -- the concat for two inputs, the
    flipped weights for a dgrad -- without the prologue or the stats, which
    no single call computes; for K5 ``torch.nn.grad.conv2d_weight``; for K3
    ``F.conv_transpose2d`` and for K3-bwd its autograd; for K7-bwd the
    autograd of ``F.batch_norm`` + ReLU, and its bare time from a CUDA
    graph) and its bound.  Returns the kernels-line entries of
    K3 and K3-bwd: times, library times and bounds summed over the four
    up-convs."""
    import torch
    import torch.nn.functional as F

    from sports_field_homography_tpu_torch.ops.bn_relu_bwd import bn_relu_bwd, bn_relu_bwd_plain
    from sports_field_homography_tpu_torch.ops.conv3x3 import (
        conv3x3, conv3x3_plain, dgrad_weights)
    from sports_field_homography_tpu_torch.ops.deconv import (
        deconv2x2, deconv2x2_backward, deconv2x2_backward_plain, deconv2x2_plain)
    from sports_field_homography_tpu_torch.ops.wgrad3x3 import wgrad3x3, wgrad3x3_plain

    gen = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).bfloat16()

    def prologue(c):
        return (torch.randn((c,), generator=gen, device=dev) * 0.1,
                torch.rand((c,), generator=gen, device=dev) + 0.5,
                torch.randn((c,), generator=gen, device=dev) * 0.1)

    rows, k7_rows = [], []
    for tag, h, w, cin, cin2, cout, pro_on, st, dgrad in K2_LEVELS:
        x = rnd(BATCH, h, w, cin)
        x2 = rnd(BATCH, h, w, cin2) if cin2 else None
        if dgrad:    # the conv's weights (3, 3, Cout, Cin): its dgrad maps Cin -> Cout
            wt = dgrad_weights(rnd(3, 3, cout, cin, scale=1.0 / (3.0 * cin ** 0.5)))
        else:
            wt = rnd(3, 3, cin, cout, scale=1.0 / (3.0 * (cin + cin2) ** 0.5))
        w2 = rnd(3, 3, cin2, cout, scale=1.0 / (3.0 * (cin + cin2) ** 0.5)) if cin2 else None
        b = None if dgrad else torch.randn((cout,), generator=gen, device=dev) * 0.1
        pro = prologue(cin) if pro_on else None

        def run():
            return conv3x3(x, wt, b, pro, stats=st, x2=x2, w2=w2)

        got = routed(conv3x3, True, run)
        ref = conv3x3_plain(x, wt, b, pro, stats=st, x2=x2, w2=w2)
        if st:
            _reduction(f"K2 bf16 {tag} sums", got[1], ref[1], 1e-3)
            _repeats_bitwise(f"K2 bf16 {tag}", run)
            got, ref = got[0], ref[0]
        err = _compare(f"K2 bf16 {tag}", got, ref, 2e-2, 2e-2)
        ms = cuda_ms(run)
        xl = nchw(x) if x2 is None else torch.cat([nchw(x), nchw(x2)], dim=1)
        xl = xl.contiguous(memory_format=torch.channels_last)
        wl = oihw(wt if w2 is None else torch.cat([wt, w2], dim=2)).contiguous(
            memory_format=torch.channels_last)
        bl = None if b is None else b.bfloat16()
        lib = cuda_ms(lambda: F.conv2d(xl, wl, bl, padding=1))
        bnd = bound(2.0 * BATCH * h * w * 9 * (cin + cin2) * cout,
                    nbytes(x, wt, got) + (nbytes(x2, w2) if x2 is not None else 0))
        rows.append(("K2", tag, f"{h}x{w}", ms, lib, bnd))
        log(f"level K2 bf16 {tag} at {h}x{w}: max abs err {err:.2e}; tensor-core kernel "
            f"{ms:.3f} ms, library F.conv2d {lib:.3f} ms, bound {bnd[0]:.3f} ms ({bnd[1]}); "
            f"kernel / library {ms / lib:.2f}, kernel / bound {ms / bnd[0]:.2f} [{card}]")
        del x, x2, wt, w2, got, ref, xl, wl
    for tag, h, w, cin, cout, pro_on in K5_LEVELS:
        x, dy = rnd(BATCH, h, w, cin), rnd(BATCH, h, w, cout)
        pro = prologue(cin) if pro_on else None

        def run():
            return wgrad3x3(x, dy, pro)

        dw, db = routed(wgrad3x3, True, run)
        dw_ref, db_ref = wgrad3x3_plain(x, dy, pro)
        rel = max(_reduction(f"K5 bf16 {tag} dW", dw, dw_ref, 1e-3),
                  _reduction(f"K5 bf16 {tag} db", db, db_ref, 1e-3))
        _repeats_bitwise(f"K5 bf16 {tag}", run)
        ms = cuda_ms(run)
        lib = cuda_ms(lambda: torch.nn.grad.conv2d_weight(nchw(x), (cout, cin, 3, 3), nchw(dy),
                                                          padding=1))
        bnd = bound(2.0 * BATCH * h * w * 9 * cin * cout, nbytes(x, dy, dw, db))
        rows.append(("K5", tag, f"{h}x{w}", ms, lib, bnd))
        log(f"level K5 bf16 {tag} at {h}x{w}: rel-L2 {rel:.2e}, bitwise repeat; tensor-core "
            f"kernel {ms:.3f} ms, library conv2d_weight {lib:.3f} ms, bound {bnd[0]:.3f} ms "
            f"({bnd[1]}); kernel / library {ms / lib:.2f}, kernel / bound {ms / bnd[0]:.2f} "
            f"[{card}]")
        del x, dy, dw, db, dw_ref
    for h, w, c in K7_LEVELS:
        y = (torch.randn((BATCH, h, w, c), generator=gen, device=dev) * 2.0 + 0.3).bfloat16()
        g = rnd(BATCH, h, w, c)
        yf = y.float()
        mean = yf.mean(dim=(0, 1, 2))
        vecs = (mean, torch.rsqrt((yf * yf).mean(dim=(0, 1, 2)) - mean * mean + 1e-5),
                torch.rand((c,), generator=gen, device=dev) + 0.5,
                torch.randn((c,), generator=gen, device=dev) * 0.3)
        del yf

        def run():
            return bn_relu_bwd(y, g, *vecs)

        dx, dgam, dbet = vec_routed(bn_relu_bwd, run)
        dx_ref, dgam_ref, dbet_ref = bn_relu_bwd_plain(y, g, *vecs)
        err = _compare(f"K7-bwd bf16 dx {h}x{w}x{c}", dx, dx_ref, 2e-2, 2e-2)
        rel = max(_reduction(f"K7-bwd bf16 {h}x{w}x{c} dgamma", dgam, dgam_ref, 1e-3),
                  _reduction(f"K7-bwd bf16 {h}x{w}x{c} dbeta", dbet, dbet_ref, 1e-3))
        _repeats_bitwise(f"K7-bwd bf16 {h}x{w}x{c}", run)
        ms, bare = cuda_ms(run), graph_ms(run, n=10)
        yl = nchw(y).detach().requires_grad_()
        gl, bl = vecs[2].clone().requires_grad_(), vecs[3].clone().requires_grad_()
        out = torch.relu(F.batch_norm(yl, None, None, gl, bl, training=True, eps=1e-5))
        gn = nchw(g)
        lib = cuda_ms(lambda: torch.autograd.grad(out, (yl, gl, bl), gn, retain_graph=True))
        bnd = bound(0, nbytes(y, g, dx))
        rows.append(("K7-bwd", f"{c} channels", f"{h}x{w}", ms, lib, bnd))
        k7_rows.append((f"{h}x{w}x{c}", ms, bare, lib, bnd[0]))
        log(f"level K7-bwd bf16 {h}x{w}x{c}: dx max abs err {err:.2e}, sums rel-L2 {rel:.2e}, "
            f"bitwise repeat, 16-byte route; kernel {ms:.3f} ms timed whole, {bare:.3f} ms "
            f"bare (CUDA graph of 10), library (autograd of F.batch_norm + ReLU) {lib:.3f} ms, "
            f"bound {bnd[0]:.3f} ms ({bnd[1]}); whole / library {ms / lib:.2f}, bare / bound "
            f"{bare / bnd[0]:.2f} [{card}]")
        del y, g, dx, dx_ref, yl, out, gn
    # K3 and K3-bwd: [max abs err, ms, plain ms, library ms, flops, bytes]
    sums = {"deconv2x2": [0.0] * 6, "deconv2x2_backward": [0.0] * 6}

    def add(name, err, ms, pms, lib, flops, n_bytes):
        s = sums[name]
        s[0] = max(s[0], err)
        for i, v in enumerate((ms, pms, lib, flops, n_bytes), 1):
            s[i] += v

    for tag, h, w, cin in K3_LEVELS:
        cout = cin // 2
        x, dy = rnd(BATCH, h, w, cin), rnd(BATCH, 2 * h, 2 * w, cout)
        wt = rnd(cin, 2, 2, cout, scale=cin ** -0.5)
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1
        y = routed(deconv2x2, True, lambda: deconv2x2(x, wt, b))
        err = _compare(f"K3 bf16 {tag}", y, deconv2x2_plain(x.float(), wt.float(), b), 2e-2, 2e-2)
        ms = cuda_ms(lambda: deconv2x2(x, wt, b))
        pms = cuda_ms(lambda: deconv2x2_plain(x, wt, b))
        xn, wl, bb = nchw(x), wt.permute(0, 3, 1, 2).contiguous(), b.bfloat16()
        lib = cuda_ms(lambda: F.conv_transpose2d(xn, wl, bb, stride=2))
        flops = 2.0 * BATCH * h * w * cin * 4 * cout
        bnd = bound(flops, nbytes(x, wt, y))
        rows.append(("K3", tag, f"{h}x{w}", ms, lib, bnd))
        add("deconv2x2", err, ms, pms, lib, flops, nbytes(x, wt, y))
        log(f"level K3 bf16 {tag} at {h}x{w}: max abs err {err:.2e}; tensor-core kernel "
            f"{ms:.3f} ms, plain {pms:.3f} ms, library F.conv_transpose2d {lib:.3f} ms, bound "
            f"{bnd[0]:.3f} ms ({bnd[1]}); kernel / library {ms / lib:.2f}, kernel / bound "
            f"{ms / bnd[0]:.2f} [{card}]")

        def run():
            return deconv2x2_backward(x, dy, wt)

        dx, dw, db = routed(deconv2x2_backward, True, run)
        dx_ref, dw_ref, db_ref = deconv2x2_backward_plain(x, dy, wt)
        err = _compare(f"K3-bwd bf16 dx {tag}", dx, dx_ref, 2e-2, 2e-2)
        rel = max(_reduction(f"K3-bwd bf16 {tag} dW", dw, dw_ref, 1e-3),
                  _reduction(f"K3-bwd bf16 {tag} db", db, db_ref, 1e-3))
        _repeats_bitwise(f"K3-bwd bf16 {tag}", run)
        ms = cuda_ms(run)
        pms = cuda_ms(lambda: deconv2x2_backward_plain(x, dy, wt))
        # yardstick: the autograd of F.conv_transpose2d (forward not timed)
        xl, wg = xn.detach().requires_grad_(), wl.requires_grad_()
        bg = torch.zeros(cout, device=dev, dtype=torch.bfloat16, requires_grad=True)
        out = F.conv_transpose2d(xl, wg, bg, stride=2)
        dyn = nchw(dy)
        lib = cuda_ms(lambda: torch.autograd.grad(out, (xl, wg, bg), dyn, retain_graph=True))
        n_bytes = nbytes(x, dy, wt, dx, dw, db)
        bnd = bound(2 * flops, n_bytes)
        rows.append(("K3-bwd", tag, f"{h}x{w}", ms, lib, bnd))
        add("deconv2x2_backward", err, ms, pms, lib, 2 * flops, n_bytes)
        log(f"level K3-bwd bf16 {tag} at {h}x{w}: dx max abs err {err:.2e}, dW/db rel-L2 "
            f"{rel:.2e}, bitwise repeat; tensor-core kernels {ms:.3f} ms, plain {pms:.3f} ms, "
            f"library (autograd of F.conv_transpose2d) {lib:.3f} ms, bound {bnd[0]:.3f} ms "
            f"({bnd[1]}); kernel / library {ms / lib:.2f}, kernel / bound {ms / bnd[0]:.2f} "
            f"[{card}]")
        del x, dy, y, dx, dw, dx_ref, dw_ref, xn, xl, out, dyn
    log("levels table (kernel | shape | level | kernel ms | library ms | bound ms | bound by):")
    for k, tag, lvl, ms, lib, bnd in rows:
        log(f"| {k} | {tag} | {lvl} | {ms:.3f} | {lib:.3f} | {bnd[0]:.3f} | {bnd[1]} |")
    log("K7_LEVELS (level | timed whole ms | bare ms | library ms | bound ms):")
    for lvl, ms, bare, lib, bnd in k7_rows:
        log(f"| {lvl} | {ms:.3f} | {bare:.3f} | {lib:.3f} | {bnd:.3f} |")
    results = {}
    for name, (err, ms, pms, lib, flops, n_bytes) in sums.items():
        bnd = bound(flops, n_bytes)
        log(f"{name} bf16 (tensor cores) all four up-convs: kernel {ms:.3f} ms, plain "
            f"{pms:.3f} ms, library {lib:.3f} ms; bound {bnd[0]:.3f} ms ({bnd[1]}); kernel / "
            f"library {ms / lib:.2f} [{card}]")
        results[name] = entry(err, ms, pms, lib, bnd)
    return results


def _train_conf(work, data, name="flagship", **extra):
    conf = dict(img_dir=f"{data}/frames", mask_dir=f"{data}/masks",
                anno_dir=f"{data}/anno", anno_keys=["poi", "reproj_mse"],
                val_names=["val_game"], court_img=COURT_IMG, court_poi=COURT_POI,
                court_size=[640, 360], cp_dir=os.path.join(work, "train", name) + "/",
                opt="RMSprop", lr=0.0001, weight_decay=0.000001, epochs=1,
                batchsize=BATCH, target_size=[640, 360], unet_size=[640, 360],
                warp_size=[640, 360], mask_classes=4, resnet_name="resnet34",
                resnet_input="img+mask", seg_loss="focal", rec_loss="MSE",
                reproj_loss="RRMSE", consist_loss="focal", consist_start_iter=0,
                seg_lambda=1, rec_lambda=1, reproj_lambda=8, consist_lambda=1,
                val_step_n=3, compute_dtype="bfloat16", device="cuda")
    conf.update(extra)
    path = os.path.join(work, f"train_conf_{name}.json")
    with open(path, "w") as f:
        json.dump(conf, f, indent=1)
    return path


_BIAS_BEFORE_BN = re.compile(r"double_conv\.[03]\.bias$")


def grad_gaps(got, ref):
    """rel-L2 of each gradient in ``got`` against ``ref`` over the leaves
    the slice bounds cover (norm above 1e-6; not a conv bias that feeds a
    train-mode BN, whose true gradient is 0).  Returns (worst rel-L2, its
    name, median rel-L2, number of leaves)."""
    rels = sorted((_rel_l2(got[name], r), name) for name, r in ref.items()
                  if not _BIAS_BEFORE_BN.search(name) and float(r.norm()) >= 1e-6)
    return rels[-1][0], rels[-1][1], statistics.median(r for r, _ in rels), len(rels)


def _parity_setup(device, size, batch_size, seed, dtype, perturb=0.0, bilinear=False):
    """The flagship (or its bilinear-UNet variant) in training mode (seeded
    torch-default weights, each scaled by ``1 + perturb``), a batch of
    seeded synthetic court renders at ``size`` (W, H), the court template
    and points, and the example conf's losses with the consistency loss
    on."""
    import torch

    from sports_field_homography_tpu_torch.data.assets import open_court_template
    from sports_field_homography_tpu_torch.data.synthetic import synthetic_samples
    from sports_field_homography_tpu_torch.geometry.court import load_court_poi
    from sports_field_homography_tpu_torch.models import Reconstructor, ReconstructorConfig
    from sports_field_homography_tpu_torch.models.layers import init_weights
    from sports_field_homography_tpu_torch.train.loop import LossConfig

    (w, h), b = size, batch_size
    model = Reconstructor(ReconstructorConfig(
        target_size=(w, h), unet_size=(w, h), warp_size=(w, h),
        resnet_name="resnet34", resnet_input="img+mask", unet_bilinear=bilinear), dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    init_weights(model, gen)
    with torch.no_grad():      # identity head: vary theta per sample
        model.resnet_reg.reg.weight.copy_(
            torch.randn(model.resnet_reg.reg.weight.shape, generator=gen) * 0.02)
        for p in model.parameters():
            p.mul_(1.0 + perturb)
    model = model.to(device=device, dtype=dtype).train()
    rng = np.random.RandomState(seed)
    frames, labels, anno = synthetic_samples(b, COURT_IMG, COURT_POI, (w, h), rng=rng)
    nz = anno[..., 2].astype(np.float32)
    batch = {"image": frames, "mask": labels.astype(np.int64),
             "weight": (0.5 + 0.5 * rng.rand(b, 1)).astype(np.float32),
             "poi": anno[..., :2].astype(np.float32), "nonzeros": nz,
             "num_nonzero": np.maximum(nz.sum(1), 1.0).astype(np.float32)}
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    court = (torch.from_numpy(open_court_template(COURT_IMG, 4, size=(w, h)))
             .to(device=device, dtype=dtype) / 4)
    poi = torch.from_numpy(load_court_poi(COURT_POI).astype(np.float32)).to(device, dtype)
    cfg = LossConfig(seg_loss="focal", rec_loss="MSE", reproj_loss="RRMSE",
                     consist_loss="focal", seg_lambda=1.0, rec_lambda=1.0,
                     reproj_lambda=8.0, consist_lambda=1.0, batch_size=b)
    return model, batch, court, poi, cfg


def parity_step(device, size=(64, 36), batch_size=3, seed=5, dtype=None,
                consist_labels=None, perturb=0.0, bilinear=False):
    """The losses and gradients of one train step of the flagship, or of
    its bilinear variant (``_parity_setup``), in ``dtype`` (float32 by
    default; float64 on the CPU for a reference run).  ``consist_labels``
    (B, H, W) replaces the run's own consistency labels; ``perturb`` scales
    every weight by ``1 + perturb`` (one ulp shows how far rounding moves
    the step).

    Returns (logs as floats, float64 gradients by name on the CPU, the
    consistency labels the step used, on the CPU)."""
    import torch

    from sports_field_homography_tpu_torch.train.evaluate import norm_img
    from sports_field_homography_tpu_torch.train.loop import (
        compute_losses, consistency_labels)

    model, batch, court, poi, cfg = _parity_setup(
        device, size, batch_size, seed, dtype or torch.float32, perturb, bilinear)
    preds = model(norm_img(batch["image"]), court, poi)
    used = (consist_labels.to(device) if consist_labels is not None
            else consistency_labels(preds["warp_mask"], 4))
    total, logs = compute_losses(preds, batch, 0, cfg, 4, consist_labels=used)
    total.backward()
    grads = {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    return {k: float(v) for k, v in logs.items()}, grads, used.cpu()


# module replay bounds.  Where CUDA and the CPU took the same ReLU masks,
# each tensor's rel-L2 to float64 on CUDA may not exceed MODULE_FACTOR
# times the CPU f32's (the sums of BN's dgamma and dbeta cancel, and their
# f32 error grows with the pixel count), or MODULE_FLOOR.  A mask bit whose
# pre-activation lies within an ulp of 0 follows the last bit of the batch
# statistics, which the two sum in different orders; each such bit moves
# a gradient by a discrete step, so a module whose masks differ is held to
# MODULE_FLIP_RTOL against the CPU.
MODULE_FLOOR, MODULE_FACTOR, MODULE_FLIP_RTOL = 1e-4, 4.0, 1e-2
UNET_MODULES = ("inc", "down1", "down2", "down3", "down4", "up1", "up2", "up3", "up4",
                "outc")


def _recording_relu_masks(masks):
    """A stand-in for the DoubleConv backward's ``bn_relu_bwd`` that calls
    it and appends the ReLU mask it used, recomputed on the CPU in its
    order of operations (``ops/bn_relu_bwd.py``), to ``masks``."""
    import torch

    from sports_field_homography_tpu_torch.ops.bn_relu_bwd import bn_relu_bwd

    def run(y, g, mean, rstd, gamma, beta):
        acc = torch.promote_types(y.dtype, torch.float32)
        yc, m, r, ga, be = (t.detach().cpu().to(acc) for t in (y, mean, rstd, gamma, beta))
        masks.append((yc - m) * r * ga + be > 0)
        return bn_relu_bwd(y, g, mean, rstd, gamma, beta)

    return run


def module_parity(size, batch_size, seed, bilinear=False, modules=UNET_MODULES):
    """Each UNet module (of ``modules``) of one f32 train step on the CPU
    (``_parity_setup``; the bilinear variant with ``bilinear``), run again
    from the inputs and the output cotangent it had in that step: on the
    GPU in f32, on the CPU in f32 and in float64.

    Every kernel of the train path runs here at the step's own shapes
    (ragged tiles, the skip pads of odd sizes), on a problem that rounding
    cannot blow up: one module's forward and backward, where the whole
    step's gradients are not (see ``scripts/torch_train_parity.py``).
    Returns {module: (flips, tensors)}: ``flips`` counts the ReLU mask
    bits of the module's BN+ReLU backward steps that differ, CUDA vs CPU,
    CUDA vs float64 and CPU vs float64; ``tensors`` maps the module's
    output, its input gradients and its parameter gradients (not the conv
    biases that feed a train-mode BN, whose true gradient is 0) to their
    rel-L2 in the same three pairs."""
    import copy

    import torch

    from sports_field_homography_tpu_torch.ops import double_conv
    from sports_field_homography_tpu_torch.train.evaluate import norm_img
    from sports_field_homography_tpu_torch.train.loop import compute_losses

    model, batch, court, poi, cfg = _parity_setup("cpu", size, batch_size, seed,
                                                  torch.float32, bilinear=bilinear)
    seen = {}

    def capture(name):
        def hook(_mod, inputs, out):
            seen[name] = [tuple(t.detach().clone() for t in inputs), None]
            out.register_hook(lambda g: seen[name].__setitem__(1, g.detach().clone()))
        return hook

    handles = [getattr(model, n).register_forward_hook(capture(n)) for n in modules]
    total, _ = compute_losses(model(norm_img(batch["image"]), court, poi), batch, 0,
                              cfg, 4)
    total.backward()
    for handle in handles:
        handle.remove()
    result = {}
    plain_bwd = double_conv.bn_relu_bwd
    for name in modules:
        inputs, cot = seen[name]
        runs, masks = {}, {}
        for key, dev, dt in (("cuda", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                             ("cpu64", "cpu", torch.float64)):
            mod = copy.deepcopy(getattr(model, name)).to(dev, dt).train()
            mod.zero_grad(set_to_none=True)
            xs = [t.to(dev, dt, copy=True).requires_grad_() for t in inputs]
            out = mod(*xs)
            masks[key] = []
            double_conv.bn_relu_bwd = _recording_relu_masks(masks[key])
            try:
                out.backward(cot.to(dev, dt))
            finally:
                double_conv.bn_relu_bwd = plain_bwd
            got = {"output": out.detach()}
            got.update({f"input {i} grad": x.grad for i, x in enumerate(xs)})
            got.update({f"{n} grad": p.grad for n, p in mod.named_parameters()
                        if not _BIAS_BEFORE_BN.search(n)})
            runs[key] = {k: v.double().cpu() for k, v in got.items()}

        def flips(a, r):
            return sum(int((x != y).sum()) for x, y in zip(masks[a], masks[r]))

        result[name] = (
            (flips("cuda", "cpu"), flips("cuda", "cpu64"), flips("cpu", "cpu64")),
            {k: (_rel_l2(runs["cuda"][k], v), _rel_l2(runs["cuda"][k], r64), _rel_l2(v, r64))
             for (k, v), r64 in zip(runs["cpu"].items(), runs["cpu64"].values())})
    return result


def train_cli_counted(conf, tag, bilinear=False):
    """The train CLI in-process on ``conf`` with every training kernel's
    counts set to 0 just before and read just after: every bf16 K2, K5, K3
    and K3-bwd launch must have taken the tensor-core route, every K7-bwd
    call the 16-byte route, and every training kernel (K3 and K3-bwd but
    for the bilinear UNet, where they must not run) must have launched.
    Returns (the CLI's history, the launch counts)."""
    import torch

    from sports_field_homography_tpu_torch.cli import train as train_cli
    from sports_field_homography_tpu_torch.ops.bn_relu import bn_relu_norm, bn_relu_stats
    from sports_field_homography_tpu_torch.ops.bn_relu_bwd import bn_relu_bwd
    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3
    from sports_field_homography_tpu_torch.ops.deconv import deconv2x2, deconv2x2_backward
    from sports_field_homography_tpu_torch.ops.wgrad3x3 import wgrad3x3

    counters = {"conv3x3": conv3x3, "deconv2x2": deconv2x2,
                "deconv2x2_backward": deconv2x2_backward, "wgrad3x3": wgrad3x3,
                "bn_relu_bwd": bn_relu_bwd, "bn_relu_stats": bn_relu_stats,
                "bn_relu_norm": bn_relu_norm}
    for fn in counters.values():
        fn.launches = 0
    conv3x3.stats_launches = conv3x3.dual_launches = conv3x3.tc_launches = 0
    wgrad3x3.tc_launches = deconv2x2.tc_launches = deconv2x2_backward.tc_launches = 0
    bn_relu_bwd.vec_launches = 0
    hist = train_cli.main(["-c", conf])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    launches["conv3x3_stats"] = conv3x3.stats_launches
    launches["conv3x3_dual"] = conv3x3.dual_launches
    routes = {k: (counters[k].tc_launches, counters[k].launches)
              for k in ("conv3x3", "wgrad3x3", "deconv2x2", "deconv2x2_backward")}
    log(f"{tag}: kernel launches in the CLI run: {launches}; on the tensor cores: "
        + ", ".join(f"{k} {t} of {n}" for k, (t, n) in routes.items())
        + f"; K7-bwd on the 16-byte route: {bn_relu_bwd.vec_launches} of "
        f"{bn_relu_bwd.launches}")
    if any(t != n for t, n in routes.values()):
        raise AssertionError(f"{tag}: a bf16 K2, K5, K3 or K3-bwd launch left the "
                             "tensor-core route")
    if bn_relu_bwd.vec_launches != bn_relu_bwd.launches:
        raise AssertionError(f"{tag}: a bf16 K7-bwd call left the 16-byte route")
    deconv_only = ("deconv2x2", "deconv2x2_backward")
    for name, n in launches.items():
        if n <= 0 and not (bilinear and name in deconv_only):
            raise AssertionError(f"{tag}: {name} was never launched by the path")
    if bilinear and any(launches[k] for k in deconv_only):
        raise AssertionError(f"{tag}: K3 or K3-bwd was launched by the bilinear UNet")
    return hist, launches


def phase_train(dev, card, work, bilinear=False):
    """The train CLI through the training kernels (deconv or bilinear
    UNet), its checkpoint through the predict CLI, and the step time."""
    import torch

    from sports_field_homography_tpu_torch.cli import predict as predict_cli
    from sports_field_homography_tpu_torch.data.synthetic import write_synthetic_dataset

    variant = "bilinear" if bilinear else "flagship"
    torch.backends.cudnn.allow_tf32 = True      # the bf16 CLI's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    data = os.path.join(work, "synth")
    if not os.path.isdir(data):
        t0 = time.perf_counter()
        write_synthetic_dataset(data, 3 * BATCH, BATCH, COURT_IMG, COURT_POI,
                                size=(640, 360), seed=0)
        log(f"train: wrote {4 * BATCH} synthetic 640x360 samples in "
            f"{time.perf_counter() - t0:.1f} s")
    conf = _train_conf(work, data, variant, unet_bilinear=bilinear)

    t0 = time.perf_counter()
    hist, launches = train_cli_counted(conf, f"train {variant}", bilinear)
    secs = time.perf_counter() - t0
    steps = hist["steps"]
    if len(steps) != 3 or len(hist["validations"]) != 1:
        raise AssertionError(f"train {variant}: {len(steps)} steps and "
                             f"{len(hist['validations'])} validations, expected 3 and 1")
    for i, st in enumerate(steps):
        if not all(np.isfinite(v) for v in st.values()):
            raise AssertionError(f"train {variant}: step {i + 1} has a non-finite loss: {st}")
        log(f"train {variant}: step {i + 1}: " + ", ".join(f"{k} {v:.5f}"
                                                            for k, v in st.items()))
    val = hist["validations"][0]
    if not all(np.isfinite(v) for v in val.values()):
        raise AssertionError(f"train {variant}: non-finite validation result {val}")
    log(f"train {variant}: validation {json.dumps(val)}; CLI total {secs:.1f} s [{card}]")

    ckpt = os.path.join(hist["cp_dir"], "CP_epoch1.pth")
    dst = os.path.join(work, f"train_predict_{variant}")
    predict_cli.process(["--img_dir", os.path.join(data, "frames", "val_game"),
                         "--load", ckpt, "--dst_dir", dst, "--req_outputs",
                         "theta,consistency", "--batchsize", str(BATCH),
                         "--court_img", COURT_IMG, "--court_poi", COURT_POI])
    with open(os.path.join(dst, "val_game_court.json")) as f:
        out = json.load(f)
    out.pop("model")
    if len(out) != BATCH or not all(np.isfinite(r["score"]) and np.isfinite(r["theta"]).all()
                                    for r in out.values()):
        raise AssertionError(f"train {variant}: the predict CLI did not write finite "
                             "records from the trained checkpoint")
    log(f"train {variant}: the predict CLI loaded {ckpt} (its conf.yaml beside it) and "
        f"wrote {len(out)} finite records")

    # step time at the flagship size
    torch.backends.cudnn.allow_tf32 = True
    ms = cuda_ms(flagship_train_step(dev, BATCH, bilinear), warmup=2, runs=5)
    log(f"train {variant}: 640x360 bf16 batch {BATCH}: {ms:.1f} ms/step, "
        f"{BATCH * 1000.0 / ms:.1f} img/s (CUDA events, median of 5 steps after "
        f"2 warm-up) [{card}]")
    return launches, hist["cp_dir"], data


# A data-parallel rank: the train or predict CLI in a child process, with
# every kernel's counts, the all-reduces' host seconds (each after a device
# sync, so only the collective itself is timed) and any call of a plain
# K7-bwd version, printed as one DP_COUNTS line.
DP_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from sports_field_homography_tpu_torch.ops import bn_relu_bwd as k7b
from sports_field_homography_tpu_torch.ops.bn_relu import bn_relu_norm, bn_relu_stats
from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3
from sports_field_homography_tpu_torch.ops.deconv import deconv2x2, deconv2x2_backward
from sports_field_homography_tpu_torch.ops.warp import warp_nearest
from sports_field_homography_tpu_torch.ops.wgrad3x3 import wgrad3x3

reduce = {"calls": 0, "seconds": 0.0, "bytes": 0}
all_reduce = dist.all_reduce

def timed_all_reduce(t, *a, **k):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    out = all_reduce(t, *a, **k)
    reduce["seconds"] += time.perf_counter() - t0
    reduce["calls"] += 1
    reduce["bytes"] += t.numel() * t.element_size()
    return out

dist.all_reduce = timed_all_reduce
plain = {"calls": 0}
for name in ("bn_relu_bwd_plain", "bn_relu_bwd_sums_plain", "bn_relu_bwd_dx_plain"):
    def counted(*a, _f=getattr(k7b, name), **k):
        plain["calls"] += 1
        return _f(*a, **k)
    setattr(k7b, name, counted)
out = {}
if sys.argv[2] == "train":
    from sports_field_homography_tpu_torch.cli.train import main
    from sports_field_homography_tpu_torch.train import loop
    step_reduce = []
    train_step = loop.train_step

    def reduce_counted_step(*a, **k):
        before = reduce["seconds"]
        logs = train_step(*a, **k)
        step_reduce.append(reduce["seconds"] - before)
        return logs

    loop.train_step = reduce_counted_step
    hist = main(sys.argv[3:])
    out["steps"] = hist["steps"]
    out["step_all_reduce_seconds"] = step_reduce
else:
    from sports_field_homography_tpu_torch.cli.predict import process
    process(sys.argv[3:])
torch.cuda.synchronize()
fns = {"conv3x3": conv3x3, "wgrad3x3": wgrad3x3, "deconv2x2": deconv2x2,
       "deconv2x2_backward": deconv2x2_backward, "bn_relu_stats": bn_relu_stats,
       "bn_relu_norm": bn_relu_norm, "bn_relu_bwd": k7b.bn_relu_bwd,
       "bn_relu_bwd_sums": k7b.bn_relu_bwd_sums, "bn_relu_bwd_dx": k7b.bn_relu_bwd_dx,
       "warp_nearest": warp_nearest}
out["launches"] = {n: f.launches for n, f in fns.items()}
out["launches"]["conv3x3_stats"] = conv3x3.stats_launches
out["launches"]["conv3x3_dual"] = conv3x3.dual_launches
out["tc"] = {n: fns[n].tc_launches for n in ("conv3x3", "wgrad3x3", "deconv2x2",
                                              "deconv2x2_backward")}
out["vec"] = {n: fns[n].vec_launches for n in ("bn_relu_bwd_sums", "bn_relu_bwd_dx",
                                                "warp_nearest")}
out["plain_k7bwd_calls"] = plain["calls"]
out["all_reduce"] = reduce
print("DP_COUNTS " + json.dumps(out), flush=True)
"""
DP_BATCH = 16                   # the global batch of the data-parallel train run
DP_N_TRAIN = 2 * DP_BATCH + 9   # three steps; the tail of 9 splits 5 + 4
DP_FRAMES = 32
DP_TIMEOUT = 240                # seconds a rank may take


def _dp_ranks(groups, out_dir):
    """Two ranks for each group (``{tag: argv_of}``, rank ``i`` runs
    ``argv_of(i)``), every group started at once, all on cuda:0; returns
    ``{tag: [each rank's output]}``.  A rank that fails fails the phase."""
    procs, paths = [], []
    for tag, argv_of in groups.items():
        for i in range(2):
            paths.append(os.path.join(out_dir, f"{tag}_rank{i}.log"))
            with open(paths[-1], "w") as f:
                procs.append(subprocess.Popen(argv_of(i), cwd=REPO, stdout=f,
                                              stderr=subprocess.STDOUT))
    try:
        rcs = [p.wait(timeout=DP_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [open(path).read() for path in paths]
    if any(rcs):
        raise AssertionError(f"data parallel {list(groups)}: ranks exited {rcs}:\n"
                             + "\n=====\n".join(o[-3000:] for o in outs))
    return {tag: outs[2 * k:2 * k + 2] for k, tag in enumerate(groups)}


def _dp_counts(out):
    line = next(ln for ln in out.splitlines() if ln.startswith("DP_COUNTS "))
    return json.loads(line[len("DP_COUNTS "):])


def _dp_split_k7bwd(dev, card):
    """The split K7-bwd (``bn_relu_bwd_sums``, the all-reduce's place, then
    ``bn_relu_bwd_dx``) against its plain versions at 360x640x64, batch 8,
    f32 and bf16, and timed beside the ATen pair SyncBatchNorm uses."""
    import torch

    from sports_field_homography_tpu_torch.ops.bn_relu_bwd import (
        _relu_grad, bn_relu_bwd_dx, bn_relu_bwd_dx_plain, bn_relu_bwd_sums,
        bn_relu_bwd_sums_plain)

    gen = torch.Generator(device=dev).manual_seed(13)
    c, m = 64, BATCH * 360 * 640
    y = torch.randn(BATCH, 360, 640, c, device=dev, generator=gen) * 2.0 + 0.3
    g = torch.randn(BATCH, 360, 640, c, device=dev, generator=gen)
    mean = y.mean(dim=(0, 1, 2))
    rstd = torch.rsqrt((y * y).mean(dim=(0, 1, 2)) - mean * mean + 1e-5)
    gamma = torch.rand((c,), generator=gen, device=dev) + 0.5
    beta = torch.randn((c,), generator=gen, device=dev) * 0.3
    vecs = (mean, rstd, gamma, beta)

    def split(yy, gg):
        sums = bn_relu_bwd_sums(yy, gg, *vecs)
        return bn_relu_bwd_dx(yy, gg, *vecs, sums, m), sums

    dx, sums = vec_routed(bn_relu_bwd_dx, lambda: split(y, g))
    # exact sums over the f32 ReLU mask the kernel and the plain version share
    # (a float64 run would flip mask bits at the boundary, each worth ~4e-4
    # of a sum here)
    xhat, dyp = _relu_grad(y, g, *vecs)
    xhat, dyp = xhat.double(), dyp.double()
    sums64 = torch.cat([dyp.sum(dim=(0, 1, 2)), (dyp * xhat).sum(dim=(0, 1, 2))])
    del xhat, dyp
    e = _compare("split K7-bwd f32 dx", dx, bn_relu_bwd_dx_plain(y, g, *vecs, sums, m),
                 1e-4, 1e-4)
    r = _reduction("split K7-bwd f32 sums", sums, sums64, 1e-5)
    del sums64
    yb, gb = y.bfloat16(), g.bfloat16()
    dxb, sumsb = vec_routed(bn_relu_bwd_dx, lambda: split(yb, gb))
    eb = _compare("split K7-bwd bf16 dx", dxb,
                  bn_relu_bwd_dx_plain(yb, gb, *vecs, sumsb, m), 2e-2, 2e-2)
    rb = _reduction("split K7-bwd bf16 sums", sumsb,
                    bn_relu_bwd_sums_plain(yb, gb, *vecs), 1e-3)
    rep = _repeats_bitwise("split K7-bwd", lambda: split(yb, gb))
    ms = cuda_ms(lambda: split(yb, gb))
    pms = cuda_ms(lambda: bn_relu_bwd_dx_plain(yb, gb, *vecs,
                                               bn_relu_bwd_sums_plain(yb, gb, *vecs), m))
    # yardstick: the two ATen calls SyncBatchNorm's backward makes around its
    # all-reduce (BN backward without the ReLU mask), on the same bf16 tensors
    yl, gl = nchw(yb), nchw(gb)
    count = torch.tensor([m], dtype=torch.int32, device=dev)

    def library():
        sdy, sdyx, _, _ = torch.batch_norm_backward_reduce(gl, yl, mean, rstd, gamma,
                                                           True, False, False)
        return torch.batch_norm_backward_elemt(gl, yl, mean, rstd, gamma, sdy, sdyx, count)

    lib = cuda_ms(library)
    bnd = bound(0, nbytes(yb, gb, dxb))
    log(f"split K7-bwd (bn_relu_bwd_sums + bn_relu_bwd_dx) 360x640x{c}: f32 dx max abs err "
        f"{e:.2e}, sums rel-L2 {r:.2e} (vs float64); bf16 dx max abs err {eb:.2e}, sums "
        f"rel-L2 {rb:.2e}; {rep}; 16-byte route; bf16 {ms:.3f} ms (2 + 1 launches), plain "
        f"{pms:.3f} ms, library (batch_norm_backward_reduce + _elemt) {lib:.3f} ms; bound "
        f"{bnd[0]:.3f} ms ({bnd[1]}) [{card}]")
    return entry(max(e, eb), ms, pms, lib, bnd)


def phase_data_parallel(dev, card, work):
    """Two ranks on cuda:0 over gloo: the train CLI, the harness's f32 step
    against one rank, the predict CLI on two hosts against one process, and
    the split K7-bwd against its plain versions."""
    import torch

    from sports_field_homography_tpu_torch.data.png import write_png
    from sports_field_homography_tpu_torch.data.synthetic import write_synthetic_dataset
    from sports_field_homography_tpu_torch.parallel.distributed import free_port

    result = _dp_split_k7bwd(dev, card)
    out_dir = os.path.join(work, "dp")
    os.makedirs(out_dir, exist_ok=True)

    # 1. the train CLI: the flagship at 640x360, bf16, global batch 16, 3 steps
    data = os.path.join(work, "dp_synth")
    t0 = time.perf_counter()
    write_synthetic_dataset(data, DP_N_TRAIN, 4, COURT_IMG, COURT_POI, size=(640, 360),
                            seed=3)
    log(f"data parallel: wrote {DP_N_TRAIN + 4} synthetic 640x360 samples in "
        f"{time.perf_counter() - t0:.1f} s")
    conf = _train_conf(work, data, "dp", batchsize=DP_BATCH)
    port = free_port()
    outs = _dp_ranks({"train": lambda i: [
        sys.executable, "-c", DP_CHILD, REPO, "train", "-c", conf, "--num_hosts", "2",
        "--host_id", str(i), "--coordinator", f"127.0.0.1:{port}"]}, out_dir)["train"]
    counts = [_dp_counts(o) for o in outs]
    backends = [re.search(r"backend (\w+)", o).group(1) for o in outs]
    log(f"data parallel train: backends {backends}")
    if backends != ["gloo", "gloo"]:
        raise AssertionError(f"data parallel: two ranks on one card took {backends}")
    must = ("conv3x3", "conv3x3_stats", "conv3x3_dual", "wgrad3x3", "deconv2x2",
            "deconv2x2_backward", "bn_relu_stats", "bn_relu_norm", "bn_relu_bwd_sums",
            "bn_relu_bwd_dx")
    for rank, cnt in enumerate(counts):
        la = cnt["launches"]
        log(f"data parallel train rank {rank}: kernel launches {la}; tensor cores "
            f"{cnt['tc']}; 16-byte route {cnt['vec']}; all-reduces {cnt['all_reduce']}")
        missing = [k for k in must if la[k] <= 0]
        if missing:
            raise AssertionError(f"data parallel rank {rank}: {missing} never launched")
        if la["bn_relu_bwd"] or cnt["plain_k7bwd_calls"]:
            raise AssertionError(f"data parallel rank {rank}: a K7-bwd ran unsplit "
                                 f"({la['bn_relu_bwd']}) or plain "
                                 f"({cnt['plain_k7bwd_calls']})")
        if la["bn_relu_bwd_sums"] != la["bn_relu_bwd_dx"] or any(
                cnt["vec"][k] != la[k] for k in ("bn_relu_bwd_sums", "bn_relu_bwd_dx")):
            raise AssertionError(f"data parallel rank {rank}: the split K7-bwd's halves "
                                 "differ in count or left the 16-byte route")
        if any(cnt["tc"][k] != la[k] for k in cnt["tc"]):
            raise AssertionError(f"data parallel rank {rank}: a bf16 launch left the "
                                 "tensor cores")
    steps = [c["steps"] for c in counts]
    if len(steps[0]) != 3 or steps[0] != [dict(s, seconds=a["seconds"], wait=a["wait"])
                                          for s, a in zip(steps[1], steps[0])]:
        raise AssertionError(f"data parallel: the ranks' step logs differ or are not 3: "
                             f"{steps}")
    if not all(np.isfinite(v) for st in steps[0] for v in st.values()):
        raise AssertionError(f"data parallel: non-finite losses {steps[0]}")
    if not os.path.isfile(os.path.join(work, "train", "dp", "CP_epoch1.pth")):
        raise AssertionError("data parallel: rank 0 wrote no CP_epoch1.pth")
    secs = [st["seconds"] for st in steps[0]]
    red, step_red = counts[0]["all_reduce"], counts[0]["step_all_reduce_seconds"]
    log(f"data parallel train: 640x360 bf16 global batch {DP_BATCH} on two ranks sharing "
        f"the card: steps {', '.join(f'{x * 1e3:.1f}' for x in secs)} ms (host clock, "
        f"steps 2-3 {sum(secs[1:]) / 2 * 1e3:.1f} ms/step); in all-reduces "
        f"{', '.join(f'{x * 1e3:.1f}' for x in step_red)} ms a step, "
        f"{sum(step_red[1:]) / sum(secs[1:]) * 100:.1f} % of steps 2-3 (rank 0; each "
        f"timed after a device sync, waits on the other rank included); the run's "
        f"{red['calls']} all-reduces moved {red['bytes'] / 1e6:.1f} MB [{card}]")

    # 2. at once, each pair on the card: the harness at 128x72, f32, global
    # batch 4, against one rank (one RMSprop step; the multi-step SGD
    # contract), and the predict CLI on two hosts, merged, against the one
    # process run before them
    frames = os.path.join(work, "dp_game")
    os.makedirs(frames, exist_ok=True)
    rng = np.random.default_rng(5)
    for i in range(DP_FRAMES):
        write_png(os.path.join(frames, f"{i:06d}.png"),
                  rng.integers(0, 256, size=(360, 640, 3), dtype=np.uint8))
    ckpt = os.path.join(work, "flagship", "model.pth")
    argv = ["--img_dir", frames, "--load", ckpt, "--req_outputs", "theta,consistency",
            "--batchsize", str(BATCH), "--court_img", COURT_IMG, "--court_poi", COURT_POI]
    one_dst, two_dst = os.path.join(out_dir, "predict_one"), os.path.join(out_dir, "predict_two")
    from sports_field_homography_tpu_torch.cli import predict as predict_cli
    predict_cli.process(argv + ["--dst_dir", one_dst])

    ports = set()

    def new_port():
        port = free_port()
        while port in ports:
            port = free_port()
        ports.add(port)
        return port

    def harness(*extra):
        port = new_port()
        return lambda i: [sys.executable, "-m", f"{PKG}.parallel.distributed", "--smoke",
                          str(i), "2", str(port), "--device", "cuda:0", "--size", "128",
                          "72", *extra]

    predict_port = new_port()
    outs = _dp_ranks({"harness_step": harness(),
                      "harness_multistep": harness("--steps", "4"),
                      "predict": lambda i: [
                          sys.executable, "-c", DP_CHILD, REPO, "predict"] + argv + [
                          "--dst_dir", two_dst, "--num_hosts", "2", "--host_id", str(i),
                          "--coordinator", f"127.0.0.1:{predict_port}"]}, out_dir)

    def fields(tag, line_tag):
        return [dict(kv.split("=", 1) for kv in next(
            ln for ln in o.splitlines() if ln.startswith(line_tag)).split()[1:])
            for o in outs[tag]]

    lines = fields("harness_step", "DIST_SMOKE")
    a = lines[0]
    log(f"data parallel f32 RMSprop step 128x72 batch 4: {a}")
    loss_gap = abs(float(a["loss"]) - float(a["local"])) / max(abs(float(a["local"])), 1e-30)
    if (lines[0]["digest"] != lines[1]["digest"] or loss_gap > 2e-3
            or float(a["grad_rel_l2"]) >= 2e-2 or float(a["stats_vs_bound"]) > 1.0):
        raise AssertionError(f"data parallel: the f32 two-rank step is outside the CPU "
                             f"test's bounds of the one-rank step: {lines}")
    lines = fields("harness_multistep", "DIST_MULTISTEP")
    a = lines[0]
    log(f"data parallel f32 multi-step contract 128x72 batch 4, 4 SGD steps: {a}")
    if (lines[0]["digest"] != lines[1]["digest"]
            or any(ln["resume_bit_equal"] != "True" for ln in lines)
            or float(a["maxabs"]) > 1e-5):
        raise AssertionError(f"data parallel: the multi-step contract failed on the card "
                             f"(one digest, a bit-equal resume, params within 1e-5 of one "
                             f"rank): {lines}")

    for rank, o in enumerate(outs["predict"]):
        la = _dp_counts(o)["launches"]
        log(f"data parallel predict host {rank}: kernel launches {la}")
        missing = [k for k in ("warp_nearest", "conv3x3", "conv3x3_dual", "deconv2x2",
                               "bn_relu_norm") if la[k] <= 0]
        if missing:
            raise AssertionError(f"data parallel predict host {rank}: {missing} never "
                                 "launched")
    with open(os.path.join(one_dst, "dp_game_court.json")) as f:
        one = json.load(f)
    with open(os.path.join(two_dst, "dp_game_court.json")) as f:
        two = json.load(f)
    if sorted(one) != sorted(two) or len(one) != DP_FRAMES + 1:
        raise AssertionError("data parallel predict: the merged JSON's frames differ from "
                             "the one-process run's")
    names = [k for k in one if k != "model"]
    theta_gap = max(float(np.abs(np.subtract(one[k]["theta"], two[k]["theta"])).max())
                    for k in names)
    score_gap = max(abs(one[k]["score"] - two[k]["score"]) for k in names)
    equal = sum(one[k] == two[k] for k in names)
    log(f"data parallel predict: {DP_FRAMES} frames over two hosts, merged: theta max-abs "
        f"{theta_gap:.2e}, score {score_gap:.2e} from the one-process run; {equal} of "
        f"{DP_FRAMES} records equal [{card}]")
    if theta_gap > 2e-4 or score_gap > 1e-3 + 1e-6:
        raise AssertionError("data parallel predict: the merged records are outside "
                             "docs/PARITY.md of the one-process run")
    torch.cuda.synchronize()
    result["launches"] = counts[0]["launches"]["bn_relu_bwd_sums"]
    return result


# the example conf's augmentation (conf/train_reconstructor.yaml.example)
EXAMPLE_AUG = {"apperance": {"jitter": {"brightness": 0.35, "contrast": 0.35,
                                        "saturation": 0.25, "hue": 0.25}, "blur": 5},
               "geometric": {"hflip": 0.5}}
EXAMPLE_BATCH = 26
EXAMPLE_N_TRAIN = 2 * EXAMPLE_BATCH + 5      # a ragged tail batch of 5

# the resumed run's rms rel-L2 from an uninterrupted run, at most this
# times the two uninterrupted runs' (where they are not bit-equal)
RESUME_SPREAD = 4.0
# the train CLI in a child process, under the CLI's own settings
TRAIN_CHILD = ("import sys\n"
               "sys.path.insert(0, sys.argv[1])\n"
               "from sports_field_homography_tpu_torch.cli.train import main\n"
               "main(sys.argv[2:])\n")


def _train_child(argv, out_path, signal_after=None):
    """Run the train CLI as a child process (``TRAIN_CHILD``) on ``argv``,
    its output in ``out_path``.  With ``signal_after``, send it SIGTERM once
    that text is in its output.  Returns (exit code, output)."""
    import signal

    with open(out_path, "w") as out:
        p = subprocess.Popen([sys.executable, "-c", TRAIN_CHILD, REPO] + argv, cwd=REPO,
                             stdout=out, stderr=subprocess.STDOUT)
    try:
        if signal_after is not None:
            deadline = time.time() + 300
            while signal_after not in open(out_path).read():
                if p.poll() is not None or time.time() > deadline:
                    raise AssertionError(f"train child: no '{signal_after}' before it ended:\n"
                                         + open(out_path).read()[-3000:])
                time.sleep(0.05)
            p.send_signal(signal.SIGTERM)
        rc = p.wait(timeout=600)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    return rc, open(out_path).read()


def _resume_check(work, data, card):
    """An augmented train run (batch 8, 2 epochs, validation every 5 steps,
    async epoch checkpoints) as a child process twice uninterrupted; then
    SIGTERM'd after its third step and resumed with ``--resume``, all under
    the CLI's own cuDNN settings.  The resumed run's final weights must
    equal the first run's bit for bit where the two uninterrupted runs are
    bit-equal; over the other tensors their rms rel-L2 from the first run
    may be at most ``RESUME_SPREAD`` times the two runs' own."""
    import torch

    runs = {}
    for name in ("run_a", "run_b", "stopped"):
        conf = _train_conf(work, data, name, aug=EXAMPLE_AUG, epochs=2, val_step_n=5,
                           async_ckpt=True)
        if name != "stopped":
            rc, out = _train_child(["-c", conf], os.path.join(work, f"{name}.log"))
        else:
            rc, out = _train_child(["-c", conf], os.path.join(work, f"{name}.log"),
                                   signal_after="step 3:")
            cp = os.path.join(work, "train", name)
            if rc != 0 or "Saved interrupt" not in out:
                raise AssertionError(f"resume: the SIGTERM'd run exited {rc} without its "
                                     "save:\n" + out[-3000:])
            missing = [f for f in ("last.pth", "last_state.pth", "last_state.sched.json")
                       if not os.path.exists(os.path.join(cp, f))]
            if missing:
                raise AssertionError(f"resume: the SIGTERM'd run did not write {missing}")
            with open(os.path.join(cp, "last_state.sched.json")) as f:
                sched = json.load(f)
            log(f"resume: SIGTERM after step 3 saved at {sched}")
            rc, out = _train_child(["-c", conf, "--resume"], os.path.join(work, "resumed.log"))
            if "Exact resume" not in out:
                raise AssertionError("resume: the resumed run did not resume exactly:\n"
                                     + out[-3000:])
        if rc != 0:
            raise AssertionError(f"resume: {name} exited {rc}:\n" + out[-3000:])
        runs[name] = torch.load(os.path.join(work, "train", name, "CP_epoch2.pth"),
                                map_location="cpu", weights_only=True)
    a, b, r = runs["run_a"], runs["run_b"], runs["stopped"]
    equal, rel_ab, rel_ra = 0, [], []
    for k in a:
        if torch.equal(a[k], b[k]):
            equal += 1
            if not torch.equal(r[k], a[k]):
                d = (r[k].double() - a[k].double()).abs().max().item()
                raise AssertionError(f"resume: {k} differs from the uninterrupted run's "
                                     f"({d:.3e}) where two uninterrupted runs are bit-equal")
            continue
        norm = max(a[k].double().norm().item(), 1e-30)
        rel_ab.append((a[k].double() - b[k].double()).norm().item() / norm)
        rel_ra.append((r[k].double() - a[k].double()).norm().item() / norm)
    msg = (f"resume: resumed vs uninterrupted run, {len(a)} tensors: {equal} bit-equal in both "
           f"uninterrupted runs and after the resume")
    if rel_ab:
        # three runs with the same rounding noise: tensor by tensor the
        # resumed one is the further from run a about half the time, so the
        # spread is compared over all differing tensors (rms of rel-L2); a
        # resume off by a step moves them by the step's update, which
        # rounding does not reach
        rms_ab = float(np.sqrt(np.mean(np.square(rel_ab))))
        rms_ra = float(np.sqrt(np.mean(np.square(rel_ra))))
        msg += (f"; the other {len(rel_ab)}: rms rel-L2 resumed vs run a {rms_ra:.3e}, "
                f"run b vs run a {rms_ab:.3e}, {sum(x > y for x, y in zip(rel_ra, rel_ab))} "
                f"tensors further than run b")
        if not rms_ra <= RESUME_SPREAD * rms_ab:
            raise AssertionError(msg + f": beyond {RESUME_SPREAD}x the runs' spread")
    log(msg + f" [{card}]")


def phase_train_example(dev, card, work):
    """The train CLI on the example conf (``conf/train_reconstructor.yaml
    .example``, as JSON): 640x360, batch 26, bf16, host augmentation,
    focal / MSE / RRMSE / focal, RMSprop, weight decay 1e-6, TensorBoard at
    ``log_dir``, over 57 synthetic frames (a ragged tail batch of 5) with a
    validation after the third step; its kernels' counts and routes, its
    step times and the loader's wait.  Then a ``grad_accum 2`` + ``tail
    pad`` run at batch 8 (one optimizer step per two batches, the last
    micro-batch the true 1-row tail), ms/step of the example conf's step at
    batch 26 on CUDA events, and the SIGTERM / ``--resume`` check
    (``_resume_check``)."""
    import torch

    from sports_field_homography_tpu_torch.data.synthetic import write_synthetic_dataset

    torch.backends.cudnn.allow_tf32 = True      # the bf16 CLI's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    data = os.path.join(work, "synth_example")
    t0 = time.perf_counter()
    write_synthetic_dataset(data, EXAMPLE_N_TRAIN, BATCH, COURT_IMG, COURT_POI,
                            size=(640, 360), seed=3)
    log(f"train example conf: wrote {EXAMPLE_N_TRAIN + BATCH} synthetic 640x360 samples in "
        f"{time.perf_counter() - t0:.1f} s")
    log_dir = os.path.join(work, "runs", "example")
    conf = _train_conf(work, data, "example", batchsize=EXAMPLE_BATCH, aug=EXAMPLE_AUG,
                       log_dir=log_dir, consist_start_iter=25000, val_step_n=3)
    t0 = time.perf_counter()
    hist, launches = train_cli_counted(conf, "train example conf")
    secs = time.perf_counter() - t0
    steps = hist["steps"]
    if len(steps) != 3 or len(hist["validations"]) != 1:
        raise AssertionError(f"train example conf: {len(steps)} steps and "
                             f"{len(hist['validations'])} validations, expected 3 and 1")
    for i, st in enumerate(steps):
        if not all(np.isfinite(v) for v in st.values()):
            raise AssertionError(f"train example conf: step {i + 1} has a non-finite loss: {st}")
        log(f"train example conf: step {i + 1}: " + ", ".join(f"{k} {v:.5f}"
                                                             for k, v in st.items()))
    val = hist["validations"][0]
    if not all(np.isfinite(v) for v in val.values()):
        raise AssertionError(f"train example conf: non-finite validation result {val}")
    events = [f for f in os.listdir(log_dir)] if os.path.isdir(log_dir) else []
    log(f"train example conf: validation {json.dumps(val)}; TensorBoard "
        + (f"written ({', '.join(events)})" if events else "disabled (tensorboard does not "
           "import here)") + f"; CLI total {secs:.1f} s [{card}]")
    log(f"train example conf: host seconds a step (loader wait included) "
        f"{[round(st['seconds'], 4) for st in steps]}, loader wait "
        f"{[round(st['wait'], 4) for st in steps]} (step 1 includes the first batch's "
        f"augmentation; step 3 is the 5-sample tail) [{card}]")

    # the loader alone over the same 57 frames (host clock): its steady rate,
    # which 3 steps of the CLI run, prefetching 2 batches ahead, do not show
    from sports_field_homography_tpu_torch.cli.train import prepare_dataloader

    for aug, workers in ((EXAMPLE_AUG, 8), (EXAMPLE_AUG, 1), (None, 8)):
        loader = prepare_dataloader(f"{data}/frames", f"{data}/masks", f"{data}/anno",
                                    ["poi", "reproj_mse"], ["val_game"], EXAMPLE_BATCH,
                                    (640, 360), num_workers=workers, aug=aug)[0]
        t0 = time.perf_counter()
        n = sum(len(b["name"]) for b in loader)
        per_batch = (time.perf_counter() - t0) / n * EXAMPLE_BATCH
        log(f"train example conf: the train loader alone, {'with' if aug else 'without'} "
            f"augmentation, {workers} thread(s): {per_batch:.3f} s a batch of "
            f"{EXAMPLE_BATCH} ({n} frames) [{card}]")

    conf = _train_conf(work, data, "accum", grad_accum=2, tail="pad", val_step_n=100)
    hist, accum = train_cli_counted(conf, "train grad_accum 2 + tail pad")
    steps = hist["steps"]
    n_batches = -(-EXAMPLE_N_TRAIN // BATCH)
    if len(steps) != n_batches // 2:
        raise AssertionError(f"train grad_accum 2: {len(steps)} optimizer steps for "
                             f"{n_batches} batches, expected {n_batches // 2}")
    if not all(np.isfinite(v) for st in steps for v in st.values()):
        raise AssertionError(f"train grad_accum 2: a non-finite loss: {steps}")
    log(f"train grad_accum 2 + tail pad: {len(steps)} optimizer steps for {n_batches} "
        f"batches of {BATCH} (the last a true tail of {EXAMPLE_N_TRAIN % BATCH}); Tot_loss "
        f"{[round(st['Tot_loss'], 5) for st in steps]}")

    ms = cuda_ms(flagship_train_step(dev, EXAMPLE_BATCH, example=True), warmup=2, runs=5)
    log(f"train example conf: 640x360 bf16 batch {EXAMPLE_BATCH}, float32 frames copied "
        f"from pinned host memory, consistency gate shut: {ms:.1f} ms/step, "
        f"{EXAMPLE_BATCH * 1000.0 / ms:.1f} img/s (CUDA events, median of 5 steps after "
        f"2 warm-up) [{card}]")
    _resume_check(work, data, card)
    return launches


def phase_predict_resnet50(dev, card):
    """The predict path with a resnet50 STN at 640x360, batch 8: f32 CUDA
    (TF32 off) against the CPU on the same seeded weights and frames
    (theta max-abs <= 2e-4), then the bf16 batch time (BN folded)."""
    import torch

    from sports_field_homography_tpu_torch.data.assets import open_court_template
    from sports_field_homography_tpu_torch.models import Reconstructor, ReconstructorConfig
    from sports_field_homography_tpu_torch.models.layers import init_weights
    from sports_field_homography_tpu_torch.ops.fold_bn import fold_batchnorm
    from sports_field_homography_tpu_torch.ops.warp import template_value_table

    cfg = ReconstructorConfig(resnet_name="resnet50", warp_size=(1280, 720))
    model = Reconstructor(cfg)
    gen = torch.Generator().manual_seed(0)
    init_weights(model, gen)
    with torch.no_grad():      # fresh init regresses identity: vary theta
        model.resnet_reg.reg.weight.copy_(
            torch.randn(model.resnet_reg.reg.weight.shape, generator=gen) * 5e-3)
    fold_batchnorm(model).eval()
    labels = open_court_template(COURT_IMG, 4, size=(1280, 720))
    frames = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (BATCH, 360, 640, 3), dtype=np.uint8))
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    for device in ("cuda", "cpu"):
        m = model.to(device)
        with torch.inference_mode():
            p = m.predict(frames.to(device).float() / 255.0,
                          torch.from_numpy(labels).to(device),
                          template_value_table(labels, 4).to(device))
        res[device] = p["theta"].float().cpu()
    d_theta = (res["cuda"] - res["cpu"]).abs().max().item()
    log(f"predict resnet50 f32 CUDA vs CPU, batch {BATCH}: theta max abs {d_theta:.3e} "
        f"(bound 2e-4); theta spread {res['cpu'].std(0).max().item():.3e}")
    if not d_theta <= 2e-4:
        raise AssertionError("predict resnet50: f32 CUDA and CPU theta differ beyond 2e-4")
    torch.backends.cudnn.allow_tf32 = True
    bf16 = Reconstructor(cfg, dtype=torch.bfloat16)
    bf16.load_state_dict(model.state_dict())
    bf16 = bf16.to(dev).eval()
    xb, lab, table = (frames.to(dev), torch.from_numpy(labels).to(dev),
                      template_value_table(labels, 4).to(dev))

    def step():
        with torch.inference_mode():
            bf16.predict(xb.float() / 255.0, lab, table)

    ms = cuda_ms(step, warmup=2, runs=5)
    log(f"predict resnet50: theta+consistency 640x360 bf16 batch {BATCH}: {ms:.2f} ms/batch, "
        f"{BATCH * 1000.0 / ms:.1f} frames/s (CUDA events, median of 5) [{card}]")


def _module_replay(size, b, seed, **kw):
    """``module_parity`` held to the replay bounds; logs the worst cases."""
    res = module_parity(size, b, seed, **kw)
    for mod, ((flips, _, _), got) in res.items():
        for t, (cc, c64, p64) in got.items():
            if flips:
                ok, why = cc <= MODULE_FLIP_RTOL, f"{cc:.3e} against the CPU"
            else:
                ok = c64 <= max(MODULE_FLOOR, MODULE_FACTOR * p64)
                why = f"{c64:.3e} against float64, CPU f32 {p64:.3e}"
            if not ok:
                raise AssertionError(f"train parity: module {mod} at {size} batch {b} "
                                     f"({flips} ReLU mask bits differ): {t} rel-L2 {why}")
    same = [(c64, p64, f"{mod} {t}") for mod, ((f, _, _), got) in res.items() if not f
            for t, (_, c64, p64) in got.items()]
    moved = {mod: (f, max(e[0] for e in got.values()))
             for mod, ((f, _, _), got) in res.items() if f}
    c64, p64, what = max(same) if same else (0.0, 0.0, "none")
    log(f"train f32 module replay{' (bilinear)' if kw.get('bilinear') else ''} at "
        f"{size[0]}x{size[1]} batch {b}: same ReLU masks in {len(same)} tensors of "
        f"{len(res) - len(moved)} modules, worst CUDA vs float64 {c64:.3e} ({what}; CPU f32 "
        f"{p64:.3e}; bound max({MODULE_FLOOR:.0e}, {MODULE_FACTOR:g} x CPU's)); mask bits "
        "that differ from the CPU's: " + (
            ", ".join(f"{mod} {f} (worst tensor {e:.3e} vs CPU)"
                      for mod, (f, e) in moved.items()) or "none")
        + f" (bound {MODULE_FLIP_RTOL:.0e})")


def _step_parity(tag, bilinear=False, seed=5):
    """One f32 train step at 64x36 batch 3, CUDA (TF32 off, deterministic
    cuDNN) against the CPU's plain versions, with a float64 run and a run
    whose weights moved by one ulp beside them.  Losses at the slice
    bounds; each gradient within 2e-2 rel-L2 (the deconv flagship), or,
    for the bilinear one, within 2e-2 plus twice the rel-L2 by which one
    ulp on the CPU run's weights moves that gradient: that case's rounding
    floor, a few hundredths at this size (``tests/test_torch_bilinear.py``
    measures the same of the JAX step)."""
    import torch

    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3
    from sports_field_homography_tpu_torch.ops.deconv import deconv2x2, deconv2x2_backward
    from sports_field_homography_tpu_torch.ops.wgrad3x3 import wgrad3x3

    kw = dict(seed=seed, bilinear=bilinear)
    kernels = (conv3x3, wgrad3x3, deconv2x2, deconv2x2_backward)
    counts = [(k.launches, k.tc_launches) for k in kernels]
    lg, gg, _ = parity_step("cuda", **kw)
    (k2_n, k2_tc), (k5_n, k5_tc), (k3_n, k3_tc), (k3b_n, k3b_tc) = (
        (k.launches - n, k.tc_launches - t) for k, (n, t) in zip(kernels, counts))
    if (k2_n <= 0 or k5_n <= 0 or (k3_n <= 0) != bilinear or (k3b_n <= 0) != bilinear
            or k2_tc or k5_tc or k3_tc or k3b_tc):
        raise AssertionError(f"{tag}: the f32 step's K2 / K5 / K3 / K3-bwd did not run on the "
                             f"SIMT route alone ({k2_tc} of {k2_n}, {k5_tc} of {k5_n}, {k3_tc} "
                             f"of {k3_n}, {k3b_tc} of {k3b_n} on tensor cores)")
    (lc, gc, _), (_, g64, _), (_, gu, _) = (
        parity_step("cpu", **kw),
        parity_step("cpu", dtype=torch.float64, **kw),
        parity_step("cpu", perturb=2.0 ** -23, **kw))
    floor_factor = 2.0 if bilinear else 0.0
    worst_loss = 0.0
    for k in ("Seg_loss", "Rec_loss", "Reproj_loss", "Cons_loss", "Tot_loss"):
        rtol, atol = (1e-2, 1e-3) if k == "Cons_loss" else (2e-3, 1e-4)
        if not abs(lg[k] - lc[k]) <= atol + rtol * abs(lc[k]):
            raise AssertionError(f"{tag}: {k} CUDA {lg[k]} vs CPU {lc[k]}")
        worst_loss = max(worst_loss, abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-30))
    checked, worst = 0, (0.0, 0.0, "")
    for name, r in gc.items():
        if _BIAS_BEFORE_BN.search(name) or float(r.norm()) < 1e-6:
            continue
        rel, floor = _rel_l2(gg[name], r), _rel_l2(gu[name], r)
        if not rel < 2e-2 + floor_factor * floor:
            raise AssertionError(f"{tag}: grad {name} rel-L2 {rel:.3e} >= 2e-2 + "
                                 f"{floor_factor:g} x {floor:.3e} (one ulp)")
        worst = max(worst, (rel, floor, name))
        checked += 1
    if checked <= 50:
        raise AssertionError(f"{tag}: only {checked} gradients compared")
    _, _, median, _ = grad_gaps(gg, gc)
    ulp_worst, ulp_name, ulp_median, _ = grad_gaps(gu, gc)
    to64 = {d: grad_gaps(g, g64) for d, g in (("CUDA", gg), ("CPU", gc))}
    log(f"{tag}: f32 CUDA vs CPU, one step at 64x36 batch 3, seed {seed} (reproj loss "
        f"{lc['Reproj_loss']:.3f}): worst loss rel diff "
        f"{worst_loss:.3e} (bound 2e-3, Cons 1e-2), grad rel-L2 worst {worst[0]:.3e} "
        f"({worst[2]}; one ulp moves it {worst[1]:.3e}), median {median:.3e} over "
        f"{checked} gradients (bound 2e-2 + {floor_factor:g} x one-ulp move); one ulp on "
        f"the CPU weights: "
        f"worst {ulp_worst:.3e} ({ulp_name}), median {ulp_median:.3e}; against float64: "
        + ", ".join(f"{d} worst {w:.3e} median {m:.3e}" for d, (w, _, m, _) in to64.items())
        + f"; SIMT launches K2 {k2_n}, K5 {k5_n}, K3 {k3_n}, K3-bwd {k3b_n}")
    return {"wgrad3x3_f32": k5_n, "deconv2x2_backward_f32": k3b_n}


def phase_train_parity():
    """f32 CUDA-vs-CPU parity of the train step and of its UNet modules."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    f32_launches = _step_parity("train parity")
    # every UNet module of that step, and of steps at larger and odd sizes,
    # replayed from the same inputs and cotangent on CUDA and in float64
    for size, b in (((64, 36), 3), ((128, 72), 3), ((256, 144), 2)):
        _module_replay(size, b, 5)
    torch.backends.cudnn.deterministic = False
    return f32_launches


def phase_bilinear_parity():
    """The same for the bilinear flagship: one f32 step, and its Up
    modules (bilinear up-sampling, two-input K2, mid != out) replayed.
    Seed 2: at seed 5 the bilinear model's seeded head projects the court
    near the horizon (reprojection loss ~127, where f32 rounding alone
    moves the loss by 2 %); at seed 2 the loss is 5.7 and one ulp on the
    weights moves no gradient by more than 5e-3 (``PERF.md`` section 6)."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    _step_parity("train parity (bilinear)", bilinear=True, seed=2)
    _module_replay((128, 72), 3, 2, bilinear=True, modules=("up1", "up2", "up3", "up4"))
    torch.backends.cudnn.deterministic = False


def phase_test_cli(dev, card, work, cp_dir, data):
    """The checkpoint test CLI on the deconv train run's .pth over its 8
    validation frames: bf16 through K1 on the full warp grid, K7-fwd and
    the two-input K2; then f32 CUDA against the CPU."""
    import torch

    from sports_field_homography_tpu_torch.cli import test as test_cli
    from sports_field_homography_tpu_torch.ops.bn_relu import bn_relu_norm
    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3
    from sports_field_homography_tpu_torch.ops.deconv import deconv2x2
    from sports_field_homography_tpu_torch.ops.warp import warp_nearest

    games = os.path.join(work, "test_games")
    os.makedirs(games)
    os.symlink(os.path.join(data, "frames", "val_game"), os.path.join(games, "val_game"))
    argv = ["--cp_dir", cp_dir, "--test_epochs", "1", "--img_dir", games,
            "--mask_dir", os.path.join(data, "masks"), "--anno_dir", os.path.join(data, "anno"),
            "--batchsize", str(BATCH), "--court_img", COURT_IMG, "--court_poi", COURT_POI]
    kernels = {"warp_nearest": warp_nearest, "conv3x3": conv3x3, "deconv2x2": deconv2x2,
               "bn_relu_norm": bn_relu_norm}
    for fn in kernels.values():
        fn.launches = 0
    conv3x3.dual_launches = conv3x3.tc_launches = deconv2x2.tc_launches = 0
    warp_nearest.vec_launches = 0
    with recording_k1_grids() as grids:
        res = test_cli.main(argv + ["--device", "cuda"])["1"]
    launches = _predict_launches(kernels)
    log(f"test CLI: kernel launches in the run: {launches}; K1 grids {sorted(set(grids))}, "
        f"{warp_nearest.vec_launches} of {warp_nearest.launches} on the float4 stores; on the "
        f"tensor cores: K2 {conv3x3.tc_launches} of {conv3x3.launches}, K3 "
        f"{deconv2x2.tc_launches} of {deconv2x2.launches}")
    if conv3x3.tc_launches != conv3x3.launches or deconv2x2.tc_launches != deconv2x2.launches:
        raise AssertionError("test CLI: a bf16 K2 or K3 launch left the tensor-core route")
    if warp_nearest.vec_launches != warp_nearest.launches:
        raise AssertionError("test CLI: a K1 launch left the float4 route")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"test CLI: {name} was never launched")
    if set(grids) != {((360, 640), None)}:
        raise AssertionError(f"test CLI: K1 did not run on the full 640x360 grid: {grids}")
    keys = ("val_reproj_px", "val_reproj_score", "val_seg_score", "val_rec_score",
            "val_consist_score")
    if not all(np.isfinite(res[k]) for k in keys):
        raise AssertionError(f"test CLI: non-finite scores {res}")
    with open(os.path.join(cp_dir, "test_scores.txt")) as f:
        if "Reconstruction MSE:" not in f.read():
            raise AssertionError("test CLI: no scores in test_scores.txt")
    log("test CLI bf16: " + ", ".join(f"{k} {res[k]:.6g}" for k in keys)
        + f"; {res['elapsed_ms']:.1f} ms for 8 frames (device-synchronised) [{card}]")

    tc0 = (conv3x3.tc_launches, deconv2x2.tc_launches)
    f32 = {d: test_cli.main(argv + ["--device", d, "--compute_dtype", "float32"])["1"]
           for d in ("cuda", "cpu")}
    if (conv3x3.tc_launches, deconv2x2.tc_launches) != tc0:
        raise AssertionError("test CLI f32: a K2 or K3 launch took the tensor-core route")
    worst = max(abs(f32["cuda"][k] - f32["cpu"][k]) / max(abs(f32["cpu"][k]), 1e-30)
                for k in keys)
    log("test CLI f32 CUDA vs CPU: " + ", ".join(
        f"{k} {f32['cuda'][k]:.6g} / {f32['cpu'][k]:.6g}" for k in keys)
        + f"; worst rel diff {worst:.3e} (bound 1e-3)")
    if not worst <= 1e-3:
        raise AssertionError("test CLI: f32 CUDA and CPU scores differ beyond rtol 1e-3")
    return launches


def flagship_train_step(dev, batch_size, bilinear=False, example=False):
    """A closure running one flagship (or bilinear-UNet) bf16 train step
    (seeded random weights) on a fixed batch of synthetic 640x360 court
    renders: uint8 frames on the device, the consistency gate open; with
    ``example``, the example conf's step as its CLI runs it: float32
    frames (what augmentation yields) copied each step from pinned host
    memory with ``non_blocking`` on the compute stream, as
    ``device_prefetch`` does, and the gate shut (consist_start_iter
    25000)."""
    import torch

    from sports_field_homography_tpu_torch.data.assets import open_court_template
    from sports_field_homography_tpu_torch.data.synthetic import synthetic_samples
    from sports_field_homography_tpu_torch.geometry.court import load_court_poi
    from sports_field_homography_tpu_torch.models import Reconstructor, ReconstructorConfig
    from sports_field_homography_tpu_torch.models.layers import init_weights
    from sports_field_homography_tpu_torch.train.loop import LossConfig, train_step
    from sports_field_homography_tpu_torch.train.optim import make_optimizer

    model = Reconstructor(ReconstructorConfig(unet_bilinear=bilinear), dtype=torch.bfloat16)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(dev).train()
    b = batch_size
    frames, labels, anno = synthetic_samples(b, COURT_IMG, COURT_POI, (640, 360),
                                             rng=np.random.RandomState(0))
    nz = anno[..., 2].astype(np.float32)
    batch = {"image": frames, "mask": labels.astype(np.int64),
             "weight": np.ones((b,), np.float32), "poi": anno[..., :2].astype(np.float32),
             "nonzeros": nz, "num_nonzero": np.maximum(nz.sum(1), 1.0).astype(np.float32)}
    court = (torch.from_numpy(open_court_template(COURT_IMG, 4, size=(640, 360)))
             .float().to(dev) / 4)
    poi = torch.from_numpy(load_court_poi(COURT_POI).astype(np.float32)).to(dev)
    cfg = LossConfig(seg_loss="focal", rec_loss="MSE", reproj_loss="RRMSE",
                     consist_loss="focal", seg_lambda=1.0, rec_lambda=1.0,
                     reproj_lambda=8.0, consist_lambda=1.0, batch_size=b,
                     consist_start_iter=25000 if example else 0)
    opt = make_optimizer("RMSprop", model.parameters(), 1e-4, 1e-6)
    if not example:
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        return lambda: train_step(model, opt, batch, 0, court, poi, cfg)
    batch["image"] = frames.astype(np.float32) / 255.0
    host = {k: torch.from_numpy(v).pin_memory() for k, v in batch.items()}

    def step():
        train_step(model, opt, {k: v.to(dev, non_blocking=True) for k, v in host.items()},
                   0, court, poi, cfg)
    return step


def flagship_predict_step(dev, batch_size, bilinear=False, full_outputs=False):
    """A closure running the flagship's (or the bilinear UNet's) predict
    path as the predict CLI does (bf16, BN folded, ``engine.predict_fn``,
    the kept outputs copied to pinned host memory) on a fixed batch of
    seeded uint8 640x360 frames, with seeded random weights: theta +
    consistency on the 1280x720 NCAA warp grid sampled at the logits, or
    with ``full_outputs`` also poi and the segm and warp masks (K1 on the
    full grid)."""
    import torch

    from sports_field_homography_tpu_torch.cli.engine import ModelBundle, predict_fn
    from sports_field_homography_tpu_torch.cli.predict import _to_host
    from sports_field_homography_tpu_torch.data.assets import open_court_template
    from sports_field_homography_tpu_torch.geometry.court import load_court_poi
    from sports_field_homography_tpu_torch.models import Reconstructor, ReconstructorConfig
    from sports_field_homography_tpu_torch.models.layers import init_weights
    from sports_field_homography_tpu_torch.ops.fold_bn import fold_batchnorm
    from sports_field_homography_tpu_torch.ops.warp import template_value_table

    cfg = ReconstructorConfig(warp_size=(1280, 720), unet_bilinear=bilinear)
    model = Reconstructor(cfg, dtype=torch.bfloat16)
    init_weights(model, torch.Generator().manual_seed(0))
    model = fold_batchnorm(model).to(dev).eval()
    labels_np = open_court_template(COURT_IMG, 4, size=(1280, 720))
    bundle = ModelBundle(model, torch.from_numpy(labels_np).to(dev),
                         template_value_table(labels_np, 4).to(dev),
                         load_court_poi(COURT_POI).astype(np.float32), cfg, dev)
    keep = ["theta", "consist_score"] + (["poi", "segm_mask", "warp_mask"] if full_outputs
                                         else [])
    fn = predict_fn(bundle, True, keep)
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (batch_size, 360, 640, 3), dtype=np.uint8)).to(dev)

    def run():
        with torch.inference_mode():
            return _to_host(fn(frames), dev)

    return run


SERVE_CLIENTS, SERVE_PER_CLIENT, SERVE_FRAMES = 32, 8, 64
# the first bytes of a JFIF (JPEG) file: a body that is not a PNG
JPEG_BODY = b"\xff\xd8\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00" + bytes(64)


def _http(port, method, path, body=None):
    """(status, parsed JSON) of one request on a fresh connection."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _post_all(port, bodies):
    """POST every body from its own thread, all at once; [(status, JSON)]."""
    out = [None] * len(bodies)

    def post(i):
        try:
            out[i] = _http(port, "POST", "/predict", bodies[i])
        except OSError as e:
            out[i] = (None, repr(e))

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return out


def _quantile(values, q):
    s = sorted(values)
    return s[min(len(s) - 1, int(q * len(s)))]


class ServerProcess:
    """``python -m sports_field_homography_tpu_torch.serve.server`` in a
    child process, its output drained by a thread; ``port`` once it serves."""

    def __init__(self, argv):
        self.proc = subprocess.Popen([sys.executable, "-m", f"{PKG}.serve.server"] + argv,
                                     cwd=REPO, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.lines, self.port = [], None
        found = threading.Event()

        def drain():
            for line in self.proc.stdout:
                self.lines.append(line)
                m = re.search(r"serving on http://[\d.]+:(\d+)", line)
                if m and self.port is None:
                    self.port = int(m.group(1))
                    found.set()
            found.set()

        self.drainer = threading.Thread(target=drain, daemon=True)
        self.drainer.start()
        if not found.wait(150) or self.port is None:
            self.stop()
            raise AssertionError("serve: the server did not start:\n"
                                 + "".join(self.lines)[-3000:])

    def stop(self, sig=signal.SIGTERM, timeout=120) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(sig)
        try:
            return self.proc.wait(timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            self.drainer.join(timeout=10)


def _png_sub_filtered(img):
    """(H, W, 3) uint8 as an RGB PNG whose rows all use filter 1 (Sub): the
    decoder's anti-diagonal path, where ``encode_png``'s filter 0 takes the
    shortcut."""
    import struct
    import zlib

    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int32)
    left = np.hstack([np.zeros((h, c), np.int32), x[:, :-c]])
    raw = np.hstack([np.ones((h, 1), np.int32), (x - left) & 0xFF]).astype(np.uint8)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + chunk(b"IEND", b""))


def _in_process_server(argv):
    from sports_field_homography_tpu_torch.serve.server import create_server

    httpd, batcher = create_server(argv + ["--port", "0"])
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, batcher


def _close(httpd, batcher):
    httpd.shutdown()
    httpd.server_close()
    batcher.close()


def _bucket_gap(httpd, batcher, bodies, ok, what, after_batch=None):
    """Serve ``bodies`` (32 frames) as one bucket-32 batch, call
    ``after_batch``, then serve each frame alone (bucket 1; the window
    shut).  Returns the largest theta difference of a frame between the
    two, theta's spread across the frames, and the frames' thetas alone
    (32, 3, 3).  Each frame's bucket-32
    theta must lie nearest its own alone theta (no slice mix-up)."""
    port = httpd.server_address[1]
    h0 = collections.Counter(batcher.batch_hist)
    batch = [ok(*r, f"{what} bucket 32") for r in _post_all(port, bodies)]
    h1 = collections.Counter(batcher.batch_hist)
    if after_batch is not None:
        after_batch()
    delay, batcher.max_delay = batcher.max_delay, 0.0
    try:
        alone = [ok(*_http(port, "POST", "/predict", b), f"{what} alone") for b in bodies]
    finally:
        batcher.max_delay = delay
    if h1 - h0 != {32: 1} or batcher.batch_hist - h1 != {1: len(bodies)}:
        raise AssertionError(f"serve {what}: not one bucket-32 batch and then buckets of 1: "
                             f"{dict(h1 - h0)}, {dict(batcher.batch_hist - h1)}")
    tb = np.array([r["theta"] for r in batch])
    ta = np.array([r["theta"] for r in alone])
    dist = np.abs(tb[:, None] - ta[None]).max(axis=(2, 3))
    if (dist.argmin(axis=1) != np.arange(len(bodies))).any():
        raise AssertionError(f"serve {what}: a bucket-32 response is nearer another frame's "
                             "theta than its own (slice mix-up)")
    return float(np.diag(dist).max()), float(ta.std(0).max()), ta


def phase_serve(dev, card, work):
    """The online server at the flagship's full width (seeded .pth with a
    JSON conf.yaml, bf16, BN folded, theta + poi + consistency, max batch
    32, 8 ms window, buckets 1..32).  Through ``python -m ...serve.server``
    in a child process, with the clients here: 32 sequential requests
    (p50/p99), 32 client threads x 8 requests over 64 seeded 640x360 PNGs
    (requests/s, p50/p99, the batch histogram and mean occupancy from
    /stats), the 400s for a 1280x720 PNG without cv2 and a JPEG, and
    SIGTERM (exit 0); then SIGTERM with 3 requests parked in a 2 s window
    (all 200, exit 0).  In this process with ``create_server``: the
    kernels that 32 requests in one bucket-32 batch and the same frames
    alone launched (counted from 0, routes asserted), each frame's theta
    in the bucket-32 batch against alone (bf16, and f32 with TF32 off), the
    program's device ms at every bucket, f32 CUDA against --device cpu on 2
    frames, and the host decode ms of a frame on both ``decode_png``
    paths."""
    import torch

    from sports_field_homography_tpu_torch.cli.engine import build_model
    from sports_field_homography_tpu_torch.data.image import have_cv2
    from sports_field_homography_tpu_torch.data.png import decode_png, encode_png
    from sports_field_homography_tpu_torch.ops.bn_relu import bn_relu_norm
    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3
    from sports_field_homography_tpu_torch.ops.deconv import deconv2x2
    from sports_field_homography_tpu_torch.ops.warp import warp_nearest
    from sports_field_homography_tpu_torch.serve.server import _decode_frame

    d = os.path.join(work, "serve")
    ckpt = os.path.join(d, "model.pth")
    write_seeded_model(ckpt)
    with open(os.path.join(d, "conf.yaml"), "w") as f:      # JSON: no PyYAML here
        json.dump({"target_size": [640, 360], "unet_size": [640, 360],
                   "warp_size": [640, 360], "court_size": [640, 360], "mask_classes": 4,
                   "resnet_name": "resnet34", "resnet_input": "img+mask",
                   "court_img": COURT_IMG, "court_poi": COURT_POI}, f)
    frames = np.random.default_rng(3).integers(0, 256, (SERVE_FRAMES, 360, 640, 3),
                                               dtype=np.uint8)
    bodies = [encode_png(f) for f in frames]

    def ok(status, body, what):
        if status != 200 or np.asarray(body["theta"]).shape != (3, 3) \
                or not np.isfinite(body["theta"]).all() or not np.isfinite(body["score"]) \
                or not np.isfinite(body["poi"]).all():
            raise AssertionError(f"serve: {what}: {status} {str(body)[:300]}")
        return body

    # -- the entry point in a child process, clients here
    t0 = time.perf_counter()
    server = ServerProcess(["--load", ckpt, "--port", "0"])
    start_s = time.perf_counter() - t0
    try:
        port = server.port
        alone, seq_ms = [], []
        for i in range(32):
            t = time.perf_counter()
            alone.append(ok(*_http(port, "POST", "/predict", bodies[i]), "sequential"))
            seq_ms.append((time.perf_counter() - t) * 1e3)
        _, s0 = _http(port, "GET", "/stats")
        if s0["batch_hist"] != {"1": 32}:
            raise AssertionError(f"serve: sequential requests not served alone: {s0}")
        load_ms, lock, errors = [], threading.Lock(), []

        def client(c):
            for j in range(SERVE_PER_CLIENT):
                t = time.perf_counter()
                try:
                    ok(*_http(port, "POST", "/predict",
                              bodies[(c * SERVE_PER_CLIENT + j) % SERVE_FRAMES]), "load")
                except (AssertionError, OSError) as e:
                    with lock:
                        errors.append(repr(e))
                with lock:
                    load_ms.append((time.perf_counter() - t) * 1e3)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        wall = time.perf_counter() - t
        if errors or len(load_ms) != SERVE_CLIENTS * SERVE_PER_CLIENT:
            raise AssertionError(f"serve: {len(errors)} failed requests under load: "
                                 f"{errors[:3]}")
        _, s1 = _http(port, "GET", "/stats")
        hist = {int(b): n - s0["batch_hist"].get(b, 0) for b, n in s1["batch_hist"].items()
                if n != s0["batch_hist"].get(b, 0)}
        occupancy = (s1["requests"] - s0["requests"]) / (s1["batches"] - s0["batches"])
        big = _http(port, "POST", "/predict", encode_png(np.zeros((720, 1280, 3), np.uint8)))
        jpeg = _http(port, "POST", "/predict", JPEG_BODY)
        _, s2 = _http(port, "GET", "/stats")
        _, health = _http(port, "GET", "/healthz")
    finally:
        rc = server.stop()
    log(f"serve: started in {start_s:.1f} s (model, 6 warm-up buckets); 32 sequential "
        f"requests: p50 {_quantile(seq_ms, 0.5):.2f} ms, p99 {_quantile(seq_ms, 0.99):.2f} ms "
        f"(client clock, bucket 1; the first {seq_ms[0]:.2f}, the slowest three "
        f"{', '.join(f'{v:.2f}' for v in sorted(seq_ms)[-3:])}) [{card}]")
    log(f"serve: {SERVE_CLIENTS} clients x {SERVE_PER_CLIENT} requests: "
        f"{len(load_ms) / wall:.1f} requests/s; client p50 {_quantile(load_ms, 0.5):.2f} ms, "
        f"p99 {_quantile(load_ms, 0.99):.2f} ms; batches by bucket {dict(sorted(hist.items()))}, "
        f"mean occupancy {occupancy:.2f}; /stats latency (last 1024 requests, the sequential "
        f"ones included) {s1['latency_ms']} [{card}]")
    want_big = 200 if have_cv2() else 400
    log(f"serve: 1280x720 PNG -> {big[0]} {str(big[1])[:120]}; JPEG -> {jpeg[0]} "
        f"{str(jpeg[1])[:120]}; /healthz {health}; SIGTERM -> exit {rc}")
    if big[0] != want_big or jpeg[0] != 400 or s2["errors"] != 0 \
            or health != {"ok": True, "backend": "cuda"} or rc != 0:
        raise AssertionError("serve: wrong status, errors, backend or exit code")

    # -- SIGTERM with requests parked in the batcher
    server = ServerProcess(["--load", ckpt, "--port", "0", "--buckets", "4",
                            "--max_delay_ms", "2000", "--no_warmup"])
    try:
        parked = []
        t = threading.Thread(target=lambda: parked.extend(_post_all(server.port, bodies[:3])))
        t.start()
        time.sleep(0.5)            # the 3 requests wait in the 2 s window
        rc = server.stop()
        t.join(timeout=120)
    finally:
        server.stop(signal.SIGKILL)
    for status, body in parked:
        ok(status, body, "parked at SIGTERM")
    log(f"serve: SIGTERM with 3 requests parked: {[s for s, _ in parked]}, exit {rc}")
    if len(parked) != 3 or rc != 0:
        raise AssertionError("serve: the drain lost a request or did not exit 0")

    # -- in this process: the kernels the requests launched, bucket 32 vs alone
    kernels = {"warp_nearest": warp_nearest, "conv3x3": conv3x3, "deconv2x2": deconv2x2,
               "bn_relu_norm": bn_relu_norm}
    httpd, batcher = _in_process_server(["--load", ckpt, "--max_delay_ms", "1000"])
    try:
        for fn in kernels.values():
            fn.launches = 0
        conv3x3.dual_launches = conv3x3.tc_launches = deconv2x2.tc_launches = 0
        warp_nearest.vec_launches = 0
        counted = {}
        gap, spread, alone_bf16 = _bucket_gap(
            httpd, batcher, bodies[:32], ok, "bf16",
            lambda: counted.update(_predict_launches(kernels)))
        launches = _predict_launches(kernels)
        device_ms = {}
        for b in batcher.buckets:
            x = torch.from_numpy(frames[:b]).to(dev)
            with torch.inference_mode():
                device_ms[b] = cuda_ms(lambda: batcher.run_batch(x), warmup=2, runs=7)
    finally:
        _close(httpd, batcher)
    log(f"serve: kernel launches for 32 requests in one bucket-32 batch: {counted}; for 64 "
        f"requests in 33 batches (the same 32 frames alone after it): {launches}; on the "
        f"tensor cores: K2 {conv3x3.tc_launches} of {conv3x3.launches}, K3 "
        f"{deconv2x2.tc_launches} of {deconv2x2.launches}; K1 on the float4 stores: "
        f"{warp_nearest.vec_launches} of {warp_nearest.launches}")
    if any(n <= 0 for n in counted.values()) \
            or any(n != 33 * counted[k] for k, n in launches.items()):
        raise AssertionError(f"serve: a kernel of the path was never launched, or not the "
                             f"same number of times each batch: {counted}, {launches}")
    if conv3x3.tc_launches != conv3x3.launches or deconv2x2.tc_launches != deconv2x2.launches \
            or warp_nearest.vec_launches != warp_nearest.launches:
        raise AssertionError("serve: a K2 or K3 launch left the tensor cores, or K1 the "
                             "float4 route")
    log(f"serve: bf16 theta of a frame in a bucket-32 batch against the same frame alone: "
        f"max abs {gap:.3e} over 32 frames (theta spread across frames {spread:.3e}); the "
        f"program's device time a batch (CUDA events, median of 7): " + ", ".join(
            f"bucket {b} {ms:.2f} ms ({b * 1000.0 / ms:.0f} frames/s)"
            for b, ms in device_ms.items()) + f" [{card}]")
    busy = sum(n * device_ms[b] for b, n in hist.items()) / (wall * 1e3)
    log(f"serve: under load the program's device time (each bucket's above times its batches) "
        f"covers {busy * 100:.1f} % of the {wall:.3f} s wall clock; a batch every "
        f"{wall * 1e3 / sum(hist.values()):.1f} ms on average; {len(load_ms)} requests in "
        f"{sum(b * n for b, n in hist.items())} bucket slots")

    # -- which part of the path depends on the batch in bf16: the UNet's logits
    # (K1-K3, K7-fwd; each output summed in a fixed order) or the STN (cuDNN)
    class Args:
        target_size = unet_size = warp_size = court_size = (640, 360)
        mask_classes, use_unet, use_resnet, use_warper, unet_uv = 4, True, True, True, False
        unet_bilinear, resnet_name, resnet_input = False, "resnet34", "img+mask"
        compute_dtype, device = "bfloat16", "cuda"
        court_img, court_poi = COURT_IMG, COURT_POI

    bundle = build_model(Args, load=ckpt, fold_bn=True, warp_with_nearest=True)
    x = torch.from_numpy(frames[:32]).to(dev).float() / 255.0
    with torch.inference_mode():
        p32, p1 = (bundle.model.predict(v, bundle.court_labels, bundle.value_table)
                   for v in (x, x[:1]))
    log(f"serve: bf16 frame 0 in a batch of 32 against alone: UNet logits "
        f"{'equal' if torch.equal(p32['logits'][:1], p1['logits']) else 'differ'} (max abs "
        f"{(p32['logits'][:1].float() - p1['logits'].float()).abs().max().item():.3e}), theta "
        f"max abs {(p32['theta'][:1] - p1['theta']).abs().max().item():.3e}")
    del bundle, x, p32, p1

    # -- f32 (TF32 off): bucket 32 against alone on CUDA, CUDA against --device cpu
    res = {}
    for device in ("cuda", "cpu"):
        httpd, batcher = _in_process_server(
            ["--load", ckpt, "--device", device, "--compute_dtype", "float32",
             "--buckets", "1,2,32" if device == "cuda" else "2", "--max_delay_ms", "1000",
             "--no_warmup"])
        try:
            if device == "cuda":
                gap32, _, alone_f32 = _bucket_gap(httpd, batcher, bodies[:32], ok, "f32")
            h0 = dict(batcher.batch_hist)
            res[device] = [ok(*r, f"f32 {device}")
                           for r in _post_all(httpd.server_address[1], bodies[:2])]
            if batcher.batch_hist - collections.Counter(h0) != {2: 1}:
                raise AssertionError(f"serve f32 {device}: 2 concurrent requests were not one "
                                     "bucket-2 batch")
        finally:
            _close(httpd, batcher)
    torch.backends.cudnn.allow_tf32 = True      # the bf16 CLI's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    diff = {k: max(np.abs(np.subtract(a[k], b[k])).max()
                   for a, b in zip(res["cuda"], res["cpu"])) for k in ("theta", "score", "poi")}
    log(f"serve f32: theta of a frame in a bucket-32 batch against alone on CUDA: max abs "
        f"{gap32:.3e} (bound 2e-4); bf16 against f32, each frame alone: max abs "
        f"{np.abs(alone_bf16 - alone_f32).max():.3e}; CUDA vs CPU, 2 frames in bucket 2: theta max abs {diff['theta']:.3e} "
        f"(bound 2e-4), score {diff['score']:.3e} (1e-3), poi {diff['poi']:.3e} (5e-4)")
    if not (diff["theta"] <= 2e-4 and diff["score"] <= 1e-3 and diff["poi"] <= 5e-4):
        raise AssertionError("serve: f32 CUDA and CPU responses disagree beyond the bounds")
    if not gap32 <= 2e-4:
        raise AssertionError("serve: an f32 frame's theta in bucket 32 differs from alone "
                             "beyond 2e-4")

    # -- the handler's host decode of a 640x360 frame, both decode_png paths
    sub = [_png_sub_filtered(f) for f in frames[:4]]
    times = {}
    for name, raws in (("filter 0 (shortcut)", bodies[:16]), ("Sub (anti-diagonals)", sub)):
        t = time.perf_counter()
        out = [decode_png(r) for r in raws]
        times[name] = (time.perf_counter() - t) * 1e3 / len(raws)
        if not all(np.array_equal(o, f) for o, f in zip(out, frames)):
            raise AssertionError(f"serve: decode_png {name} is not the source frame")
    t = time.perf_counter()
    for r in bodies[:16]:
        _decode_frame(r, (360, 640), "bgr")
    handler_ms = (time.perf_counter() - t) * 1e3 / 16
    log("serve: host decode of a 640x360 PNG request: decode_png " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in times.items()) + f" a frame; the handler's whole decode "
        f"(cv2 {'installed' if have_cv2() else 'absent: decode_png'}, filter 0, to BGR) "
        f"{handler_ms:.2f} ms a frame")


SERVE_BUCKETS = (1, 2, 4, 8, 16, 32)
SERVE_HW = (360, 640)
# the predict path's launches a batch (K2 of which two-input, K3, K7-fwd's
# norm, K1), the same at every bucket
PATH_LAUNCHES = {"conv3x3": 13, "conv3x3_dual": 4, "deconv2x2": 4, "bn_relu_norm": 9,
                 "warp_nearest": 1}


def _serve_conf(d):
    """phase serve's model: the seeded flagship .pth and its JSON conf.yaml
    (at ``SERVE_HW``)."""
    write_seeded_model(os.path.join(d, "model.pth"))
    size = list(SERVE_HW[::-1])
    with open(os.path.join(d, "conf.yaml"), "w") as f:      # JSON: no PyYAML here
        json.dump({"target_size": size, "unet_size": size, "warp_size": size,
                   "court_size": size, "mask_classes": 4,
                   "resnet_name": "resnet34", "resnet_input": "img+mask",
                   "court_img": COURT_IMG, "court_poi": COURT_POI}, f)
    return os.path.join(d, "model.pth")


def _counted(kernels, call, tag="serve artifact"):
    """``call()``'s launches of the predict path's kernels, counted from 0,
    every K2 and K3 launch on the tensor cores and every K1 launch on the
    float4 stores; returns (launches, what call returned)."""
    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3
    from sports_field_homography_tpu_torch.ops.deconv import deconv2x2
    from sports_field_homography_tpu_torch.ops.warp import warp_nearest

    for fn in kernels.values():
        fn.launches = 0
    conv3x3.dual_launches = conv3x3.tc_launches = deconv2x2.tc_launches = 0
    warp_nearest.vec_launches = 0
    out = call()
    if conv3x3.tc_launches != conv3x3.launches or deconv2x2.tc_launches != deconv2x2.launches \
            or warp_nearest.vec_launches != warp_nearest.launches:
        raise AssertionError(f"{tag}: a K2 or K3 launch left the tensor cores, or K1 the "
                             "float4 route")
    return _predict_launches(kernels), out


def _output_gap(got, want):
    """{output: max abs difference} of two output dicts, on the host."""
    return {k: float((got[k].double() - want[k].double()).abs().max()) for k in want}


def phase_serve_artifact(dev, card, work):
    """The serving artifact at the flagship's full width: phase serve's
    model exported on the card with ``cli.export_serving --buckets
    1,2,4,8,16,32`` (bf16, BN folded, theta + poi + consistency, 640x360),
    then served by ``python -m ...serve.server --serving_artifact`` in a
    child process under phase serve's load.  Gates: every bucket's program
    equal to the live ``predict_fn`` bit for bit on the same frames, with
    the path's launches a batch (K2 17, 4 of them two-input, K3 4, K7-fwd's
    norm 9, K1 1) on the tensor-core and float4 routes; the same launches
    through the server in this process; an f32 artifact exported on the
    card against one exported on the CPU (theta 2e-4, score 1e-3, poi
    5e-4); all requests answered, SIGTERM exit 0.  Prints each bucket's
    export seconds and MB, load seconds and device ms (beside the live
    program's), the server's start, requests/s and p50/p99; and the bf16
    batch dependence of the STN (ResNet trunk, then its linear head) replayed
    alone at buckets 1 and 32."""
    import torch
    import torch.nn.functional as F

    from sports_field_homography_tpu_torch.cli import export_serving
    from sports_field_homography_tpu_torch.cli.engine import predict_fn
    from sports_field_homography_tpu_torch.compat.serving import load_serving
    from sports_field_homography_tpu_torch.data.png import encode_png
    from sports_field_homography_tpu_torch.models.layers import bn_apply, nchw
    from sports_field_homography_tpu_torch.models.resnet import _conv
    from sports_field_homography_tpu_torch.ops.bn_relu import bn_relu_norm
    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3
    from sports_field_homography_tpu_torch.ops.deconv import deconv2x2
    from sports_field_homography_tpu_torch.ops.warp import warp_nearest
    from sports_field_homography_tpu_torch.utils.config import get_prediction_args

    h, w = SERVE_HW
    d = os.path.join(work, "serve_artifact")
    ckpt = _serve_conf(d)
    argv = ["--load", ckpt, "--req_outputs", "theta,poi,consistency", "--out_size", str(w),
            str(h), "--court_img", COURT_IMG, "--court_poi", COURT_POI]
    art = os.path.join(d, "serving")
    records = export_serving.main(argv + ["--buckets", ",".join(map(str, SERVE_BUCKETS)),
                                          "--dst", art, "--device", dev.type])
    log("serve artifact: exported on the card, " + ", ".join(
        f"bucket {r['batch']} {r['seconds']:.1f} s {r['mb']:.1f} MB" for r in records)
        + f" [{card}]")
    bundle, consistency, _, keep = export_serving.build_bundle(
        get_prediction_args(argv + ["--device", dev.type]))
    live = predict_fn(bundle, consistency, keep)
    frames = np.random.default_rng(3).integers(0, 256, (SERVE_FRAMES, h, w, 3),
                                               dtype=np.uint8)
    kernels = {"warp_nearest": warp_nearest, "conv3x3": conv3x3, "deconv2x2": deconv2x2,
               "bn_relu_norm": bn_relu_norm}
    fns, rows = {}, []
    for b in SERVE_BUCKETS:
        t0 = time.perf_counter()
        fn, meta = load_serving(os.path.join(art, f"b{b}"), dev.type)
        load_s = time.perf_counter() - t0
        fns[b] = fn
        x = torch.from_numpy(frames[:b]).to(dev)
        with torch.inference_mode():
            launches, got = _counted(kernels, lambda: fn(x))
            want = live(x)
            torch.cuda.synchronize()
            gap = _output_gap(got, want)
            equal = all(torch.equal(got[k], want[k]) for k in want)
            ms, live_ms = cuda_ms(lambda: fn(x)), cuda_ms(lambda: live(x))
        rows.append(f"bucket {b}: load {load_s:.2f} s, {'bit-equal' if equal else gap}, "
                    f"device {ms:.2f} ms (live {live_ms:.2f} ms), launches {launches}")
        if sorted(got) != meta["outputs"] or launches != PATH_LAUNCHES:
            raise AssertionError(f"serve artifact bucket {b}: outputs {sorted(got)} or "
                                 f"launches {launches}, expected {PATH_LAUNCHES}")
        if not equal:
            raise AssertionError(f"serve artifact bucket {b}: not bit-equal to the live "
                                 f"program: max abs {gap}")
    log("serve artifact: " + "; ".join(rows) + f" [{card}]")
    del fns

    # -- the entry point in a child process, with phase serve's clients here
    bodies = [encode_png(f) for f in frames]

    def ok(status, body, what):
        if status != 200 or np.asarray(body["theta"]).shape != (3, 3) \
                or not np.isfinite(body["theta"]).all() or not np.isfinite(body["score"]) \
                or not np.isfinite(body["poi"]).all():
            raise AssertionError(f"serve artifact: {what}: {status} {str(body)[:300]}")
        return body

    t0 = time.perf_counter()
    server = ServerProcess(["--serving_artifact", art, "--port", "0", "--device", dev.type])
    start_s = time.perf_counter() - t0
    try:
        port = server.port
        seq_ms = []
        for i in range(32):
            t = time.perf_counter()
            ok(*_http(port, "POST", "/predict", bodies[i]), "sequential")
            seq_ms.append((time.perf_counter() - t) * 1e3)
        _, s0 = _http(port, "GET", "/stats")
        load_ms, lock, errors = [], threading.Lock(), []

        def client(c):
            for j in range(SERVE_PER_CLIENT):
                t = time.perf_counter()
                try:
                    ok(*_http(port, "POST", "/predict",
                              bodies[(c * SERVE_PER_CLIENT + j) % SERVE_FRAMES]), "load")
                except (AssertionError, OSError) as e:
                    with lock:
                        errors.append(repr(e))
                with lock:
                    load_ms.append((time.perf_counter() - t) * 1e3)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        wall = time.perf_counter() - t
        _, s1 = _http(port, "GET", "/stats")
        _, health = _http(port, "GET", "/healthz")
    finally:
        rc = server.stop()
    started = [line.strip() for line in server.lines if "bucket artifacts" in line]
    hist = {int(b): n - s0["batch_hist"].get(b, 0) for b, n in s1["batch_hist"].items()
            if n != s0["batch_hist"].get(b, 0)}
    occupancy = (s1["requests"] - s0["requests"]) / max(1, s1["batches"] - s0["batches"])
    log(f"serve artifact: server started in {start_s:.1f} s ({started}; 6 programs loaded and "
        f"warmed; phase serve's checkpoint start above); 32 sequential requests: p50 "
        f"{_quantile(seq_ms, 0.5):.2f} ms, p99 {_quantile(seq_ms, 0.99):.2f} ms; "
        f"{SERVE_CLIENTS} clients x {SERVE_PER_CLIENT} requests: "
        f"{len(load_ms) / wall:.1f} requests/s, client p50 {_quantile(load_ms, 0.5):.2f} ms, "
        f"p99 {_quantile(load_ms, 0.99):.2f} ms; batches by bucket "
        f"{dict(sorted(hist.items()))}, mean occupancy {occupancy:.2f}; /stats latency of the "
        f"sequential ones {s0['latency_ms']}; SIGTERM -> exit {rc} [{card}]")
    if errors or len(load_ms) != SERVE_CLIENTS * SERVE_PER_CLIENT or s1["errors"] != 0 \
            or s0["batch_hist"] != {"1": 32} or health != {"ok": True, "backend": dev.type} \
            or rc != 0:
        raise AssertionError(f"serve artifact: {len(errors)} failed requests {errors[:3]}, "
                             f"errors, a sequential request not served alone, the backend "
                             f"or the exit code: {s0}, {s1}, {health}, {rc}")

    # -- the server in this process: the artifact's launches through the batcher,
    # each batch's host seconds in the worker (H2D, program, D2H), and the
    # interpreter's garbage collections meanwhile
    httpd, batcher = _in_process_server(["--serving_artifact", art, "--max_delay_ms", "1000",
                                         "--no_warmup", "--device", dev.type])
    batch_ms, gcs = [], []
    run = batcher._run

    def timed_run(host):
        t = time.perf_counter()
        try:
            return run(host)
        finally:
            batch_ms.append((host.shape[0], (time.perf_counter() - t) * 1e3))

    def on_gc(phase, info):
        if phase == "start":
            on_gc.t = time.perf_counter()
        else:
            gcs.append((info["generation"], (time.perf_counter() - on_gc.t) * 1e3))

    batcher._run = timed_run
    gc.callbacks.append(on_gc)
    try:
        launches, (gap, spread, _) = _counted(
            kernels, lambda: _bucket_gap(httpd, batcher, bodies[:32], ok, "artifact"))
    finally:
        gc.callbacks.remove(on_gc)
        _close(httpd, batcher)
    alone_ms = [ms for b, ms in batch_ms if b == 1]
    full = [ms for g, ms in gcs if g == 2]
    log(f"serve artifact: kernel launches through the server for 32 requests in one bucket-32 "
        f"batch and the same frames alone (33 batches): {launches}; bf16 theta of a frame in "
        f"bucket 32 against alone {gap:.3e} (spread across frames {spread:.3e}); the worker's "
        f"host ms a batch: bucket 32 {[round(ms, 1) for b, ms in batch_ms if b == 32]}, bucket "
        f"1 median {statistics.median(alone_ms):.1f} (max {max(alone_ms):.1f}); garbage "
        f"collections meanwhile {len(gcs)}, of them {len(full)} full ones taking "
        f"{sum(full):.1f} ms [{card}]")
    if launches != {k: 33 * n for k, n in PATH_LAUNCHES.items()}:
        raise AssertionError(f"serve artifact: the server's launches {launches}, expected 33 "
                             f"batches of {PATH_LAUNCHES}")

    # -- which layer of the STN depends on the batch in bf16: replayed alone
    model = bundle.model
    stn = model.resnet_reg
    x = torch.from_numpy(frames[:32]).to(dev).float() / 255.0
    with torch.inference_mode():
        logits, _, uv = model.forward_unet(x)
        stn_in = model._stn_input(x, logits, uv)

        def trunk(v):
            v = torch.relu(bn_apply(_conv(nchw(v), stn.conv0), stn.bn1, False))
            v = F.max_pool2d(v, 3, 2, 1)
            for stage in (stn.layer1, stn.layer2, stn.layer3, stn.layer4):
                v = stage(v)
            return v.mean(dim=(2, 3))

        def head(f):
            return F.linear(f.float(), stn.reg.weight.float(), stn.reg.bias.float())

        th32 = stn(stn_in)
        th1 = torch.cat([stn(stn_in[i:i + 1]) for i in range(32)])
        f32_ = trunk(stn_in)
        f1 = torch.cat([trunk(stn_in[i:i + 1]) for i in range(32)])
        h32, h1 = head(f32_), torch.cat([head(f32_[i:i + 1]) for i in range(32)])
        if not torch.equal(th32.view(32, 9), head(f32_)):
            raise AssertionError("serve artifact: the STN replay is not the STN")
    log(f"serve artifact: bf16 STN replayed alone, bucket 32 against bucket 1 (the same UNet "
        f"logits): theta max abs {(th32 - th1).abs().max().item():.3e}; the ResNet trunk's "
        f"pooled features {(f32_.float() - f1.float()).abs().max().item():.3e} (max "
        f"|feature| {f1.float().abs().max().item():.3e}); the linear head alone on the same "
        f"features {(h32 - h1).abs().max().item():.3e} [{card}]")
    del bundle, live, model, stn, x, logits, stn_in

    # -- f32: an artifact exported on the card against one exported on the CPU
    f32 = argv + ["--compute_dtype", "float32", "--buckets", "2"]
    outs = {}
    for device in ("cuda", "cpu"):
        on = dev.type if device == "cuda" else "cpu"
        export_serving.main(f32 + ["--dst", os.path.join(d, f"f32_{device}"), "--device", on])
        fn, _ = load_serving(os.path.join(d, f"f32_{device}", "b2"), on)
        with torch.inference_mode():
            n0 = conv3x3.launches
            outs[device] = {k: v.cpu() for k, v in
                            fn(torch.from_numpy(frames[:2]).to(on)).items()}
            if (conv3x3.launches > n0) != (on == "cuda"):
                raise AssertionError(f"serve artifact f32 {device}: K2 launches wrong")
    torch.backends.cudnn.allow_tf32 = True      # the bf16 CLI's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    diff = _output_gap(outs["cuda"], outs["cpu"])
    log(f"serve artifact f32 (TF32 off): exported on the card against exported on the CPU, "
        f"2 frames: theta max abs {diff['theta']:.3e} (bound 2e-4), score "
        f"{diff['consist_score']:.3e} (1e-3), poi {diff['poi']:.3e} (5e-4)")
    if not (diff["theta"] <= 2e-4 and diff["consist_score"] <= 1e-3 and diff["poi"] <= 5e-4):
        raise AssertionError("serve artifact: the f32 CUDA artifact disagrees with the CPU's")


LEGACY_WH = (640, 360)
LEGACY_PARITY_FRAMES = 2


def _legacy_models():
    """The legacy family at 640x360 from one seed, on the CPU in f32: the
    deconv UNet through ``utils/hubconf`` (its K3 route), a 1-class UNet
    (``eval_net``'s dice path), and ``UNetSTN`` and ``CourtReconstruction``
    on the bilinear UNet.  Weights as a trained model's are scaled, so that
    eval BatchNorm keeps the activations near unit size (He-normal convs and
    linears, BN scale and running variance in [0.5, 1.5], small biases and
    running means), and the heads' last layer varied so that theta depends
    on the frame."""
    import torch
    from torch import nn

    from sports_field_homography_tpu_torch.models import legacy
    from sports_field_homography_tpu_torch.utils import hubconf

    gen = torch.Generator().manual_seed(3)
    models = {"unet": hubconf.unet(4, bilinear=False),
              "unet 1 class": hubconf.unet(1, bilinear=False),
              "UNetSTN": legacy.UNetSTN(4, bilinear=True, input_size=LEGACY_WH),
              "CourtReconstruction": legacy.CourtReconstruction(4, target_size=LEGACY_WH,
                                                                bilinear=True)}

    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=gen) * std)

    def uniform(t, lo, hi):
        t.copy_(lo + torch.rand(t.shape, generator=gen) * (hi - lo))

    with torch.no_grad():
        for m in models.values():
            for mod in m.modules():
                if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                    fan_in = mod.weight.shape[0 if isinstance(mod, nn.ConvTranspose2d) else 1]
                    fan_in *= mod.weight[0, 0].numel() if mod.weight.dim() == 4 else 1
                    normal(mod.weight, (2.0 / fan_in) ** 0.5)
                    normal(mod.bias, 0.1)
                elif isinstance(mod, nn.BatchNorm2d):
                    uniform(mod.weight, 0.5, 1.5)
                    normal(mod.bias, 0.1)
                    normal(mod.running_mean, 0.1)
                    uniform(mod.running_var, 0.5, 1.5)
            if hasattr(m, "reg"):
                m.reg.reset_head()
                normal(m.reg.fc2.weight, 2e-3)
            m.eval()
    return models


def _on(model, device, dtype):
    """A copy of ``model`` on ``device`` computing in ``dtype``."""
    import copy

    m = copy.deepcopy(model).to(device)
    m.dtype = dtype
    return m


def _legacy_forward(model, x, template):
    """(logits, theta or None, proj or None) of one legacy model."""
    thetas = []
    if not hasattr(model, "reg"):
        return model(x), None, None
    hook = model.reg.register_forward_hook(lambda m, i, o: thetas.append(o))
    try:
        logits, proj = model(x, template)
    finally:
        hook.remove()
    return logits, thetas[0], proj


def phase_legacy(dev, card):
    """The legacy models (``models/legacy.py``) at 640x360: bf16 batch 8
    through K2, K7-fwd's norm and (deconv) K3, every launch counted from 0
    and on the tensor cores, ms a batch; f32 (TF32 off) CUDA against the CPU
    on 2 frames (logits rtol 1e-3 / atol 2e-4, theta <= 2e-4, the
    projection of the CPU's theta on the card within 1e-5 of the CPU's);
    ``eval_net`` (4 classes, and 1 class through the dice path) and
    ``eval_stn`` on two seeded batches, CUDA against the CPU, rtol 1e-3;
    ``geometry/court.Warper`` (default device: the card) at 1280x720 against
    the CPU, < 0.1 % of pixels apart."""
    import torch

    from sports_field_homography_tpu_torch.data.assets import open_court_template
    from sports_field_homography_tpu_torch.ops.bn_relu import bn_relu_norm
    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3
    from sports_field_homography_tpu_torch.ops.deconv import deconv2x2
    from sports_field_homography_tpu_torch.ops.warp import warp_nearest
    from sports_field_homography_tpu_torch.train.evaluate import eval_net, eval_stn

    w, h = LEGACY_WH
    models = _legacy_models()
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (BATCH, h, w, 3), dtype=np.uint8)
    template = torch.from_numpy(open_court_template(COURT_IMG, 4, size=LEGACY_WH)).float() / 4
    # K1 is counted too (from 0, so that the route check holds); the legacy
    # models do not launch it
    kernels = {"conv3x3": conv3x3, "deconv2x2": deconv2x2, "bn_relu_norm": bn_relu_norm,
               "warp_nearest": warp_nearest}
    torch.backends.cudnn.allow_tf32 = True      # the bf16 CLIs' defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for name in ("unet", "UNetSTN", "CourtReconstruction"):
        m = _on(models[name], dev, torch.bfloat16)
        x = torch.from_numpy(frames).to(dev).float() / 255.0
        tmpl = template.to(dev)
        with torch.inference_mode():
            launches, (logits, theta, proj) = _counted(
                kernels, lambda: _legacy_forward(m, x, tmpl), f"legacy {name}")
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: _legacy_forward(m, x, tmpl), warmup=2, runs=5)
        deconv = not m.bilinear
        if launches.pop("warp_nearest") or launches["conv3x3"] <= 0 \
                or launches["bn_relu_norm"] <= 0 or (launches["deconv2x2"] > 0) != deconv:
            raise AssertionError(f"legacy {name}: launches {launches}: K2 and K7-fwd's norm "
                                 f"must run, K3 {'must' if deconv else 'must not'}")
        outs = [logits] + ([theta, proj] if theta is not None else [])
        if not all(torch.isfinite(t.float()).all() for t in outs):
            raise AssertionError(f"legacy {name}: non-finite bf16 outputs")
        if theta is not None and float(theta.float().std(0).max()) <= 0:
            raise AssertionError(f"legacy {name}: theta does not vary across frames")
        rows.append(f"{name} ({'deconv' if deconv else 'bilinear'}) {ms:.2f} ms/batch, "
                    f"launches {launches}")
        del m
    log(f"legacy: bf16 {w}x{h} batch {BATCH} (CUDA events, median of 5): " + "; ".join(rows)
        + f" [{card}]")

    # f32 (TF32 off): the card against the CPU's plain versions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.from_numpy(frames[:LEGACY_PARITY_FRAMES]).float() / 255.0
    rows = []
    for name in ("unet", "UNetSTN", "CourtReconstruction"):
        res, on = {}, {}
        for device in ("cuda", "cpu"):
            on[device] = _on(models[name], torch.device(device), torch.float32)
            with torch.inference_mode():
                n0 = conv3x3.launches
                res[device] = [None if t is None else t.float().cpu() for t in
                               _legacy_forward(on[device], x.to(device), template.to(device))]
                if (conv3x3.launches > n0) != (device == "cuda"):
                    raise AssertionError(f"legacy {name} f32 {device}: K2 launches wrong")
        (lc, tc, pc), (lp, tp, pp) = res["cuda"], res["cpu"]
        d_logits = float((lc - lp).abs().max())
        if not torch.allclose(lc, lp, rtol=1e-3, atol=2e-4):
            raise AssertionError(f"legacy {name} f32: logits CUDA vs CPU max abs {d_logits:.3e}")
        row = f"{name}: logits max abs {d_logits:.3e}"
        if tc is not None:
            d_theta = float((tc - tp).abs().max())
            shape = (-1, 2, 3) if name == "UNetSTN" else (-1, 3, 3)
            with torch.inference_mode():    # the CPU's theta projected on the card
                proj = on["cuda"].project(tp.reshape(shape).to(dev), template.to(dev)).cpu()
            d_proj = float((proj - pp).abs().max())
            row += f", theta {d_theta:.3e}, projection of the CPU's theta {d_proj:.3e}"
            if not (d_theta <= 2e-4 and d_proj <= 1e-5):
                raise AssertionError(f"legacy {name} f32: theta {d_theta:.3e} (2e-4) or the "
                                     f"projection {d_proj:.3e} (1e-5) beyond its bound")
        rows.append(row)
    log(f"legacy f32 CUDA vs CPU, {LEGACY_PARITY_FRAMES} frames (bounds: logits rtol 1e-3 / "
        "atol 2e-4, theta 2e-4, projection 1e-5): " + "; ".join(rows))

    # the legacy scores on two seeded batches
    batches = [{"image": rng.integers(0, 256, (LEGACY_PARITY_FRAMES, h, w, 3), dtype=np.uint8),
                "mask": rng.integers(0, 4, (LEGACY_PARITY_FRAMES, h, w)).astype(np.int64)}
               for _ in range(2)]
    one_class = [dict(b, mask=(b["mask"] > 1).astype(np.int64)) for b in batches]
    scores = {}
    for device in ("cuda", "cpu"):
        d = torch.device(device)
        n0 = conv3x3.launches
        scores[device] = {
            "eval_net 4 classes": eval_net(_on(models["unet"], d, torch.float32), batches, 4),
            "eval_net 1 class": eval_net(_on(models["unet 1 class"], d, torch.float32),
                                         one_class, 1),
            "eval_stn UNetSTN": eval_stn(_on(models["UNetSTN"], d, torch.float32), batches,
                                         template.to(d), 4),
            "eval_stn CourtReconstruction": eval_stn(
                _on(models["CourtReconstruction"], d, torch.float32), batches,
                template.to(d), 4)}
        if (conv3x3.launches > n0) != (device == "cuda"):
            raise AssertionError(f"legacy eval {device}: K2 launches wrong")
    rows = []
    for what, want in scores["cpu"].items():
        for key, v in want.items():
            got = scores["cuda"][what][key]
            rows.append(f"{what} {key} {got:.6f} (CPU {v:.6f})")
            if not (np.isfinite(got) and abs(got - v) <= 1e-3 * abs(v)):
                raise AssertionError(f"legacy {what}: {key} CUDA {got} vs CPU {v} (rtol 1e-3)")
    log("legacy eval f32, 2 batches of 2: " + "; ".join(rows))
    torch.backends.cudnn.allow_tf32 = True

    # geometry/court.Warper: its default device is the card
    from sports_field_homography_tpu_torch.geometry.court import Warper

    img = np.stack([template.numpy(), rng.random((h, w), dtype=np.float32),
                    np.linspace(0, 1, w, dtype=np.float32)[None].repeat(h, 0)], axis=-1)
    theta = np.array([[1.4, 0.1, 0.05], [0.02, 2.2, 0.6], [0.01, 0.9, 1.0]])
    card_w, host_w = Warper(VIDEO_WH), Warper(VIDEO_WH, cuda=False)
    if card_w.device.type != "cuda":
        raise AssertionError("legacy: Warper's default device is not the card")
    got, want = card_w.warp(theta, img), host_w.warp(theta, img)
    differ = float(np.any(got != want, axis=-1).mean())
    log(f"legacy: geometry/court.Warper {VIDEO_WH[0]}x{VIDEO_WH[1]} of a 3-channel float image "
        f"on the card against the CPU: {differ * 100:.4f} % of pixels differ (bound 0.1 %)")
    if got.shape != (VIDEO_WH[1], VIDEO_WH[0], 3) or differ >= 1e-3 or not (got[..., 0] > 0).any():
        raise AssertionError("legacy: Warper on the card disagrees with the CPU")


PITCH_IMG = os.path.join(REPO, "assets", "pitch_mask_nc4_hd.png")
PITCH_POI = os.path.join(REPO, "assets", "template_pitch_points.json")
PITCH_FLIP = os.path.join(REPO, "assets", "pitch-poi-flip-mapping.json")
PITCH_WH = (640, 360)


def phase_pitch(dev, card, work):
    """The soccer-pitch variant (BASELINE config #5) at 640x360: a seeded
    synthetic set rendered from the RGBA class-colour pitch (converted to a
    label template by ``data/synthetic.py``, 33 points), the train CLI for
    3 steps at batch 8 with the hflip and the pitch's flip map, every
    training kernel launched on its fast route, the predict CLI on the
    validation frames from its checkpoint, and f32 (TF32 off) CUDA against
    the CPU on 2 frames: unit-normalized theta <= 2e-4, poi <= 5e-4, score
    <= 1e-3."""
    import torch

    from sports_field_homography_tpu_torch.cli import predict as predict_cli
    from sports_field_homography_tpu_torch.cli.engine import build_model
    from sports_field_homography_tpu_torch.data.dataset import BasicDataset
    from sports_field_homography_tpu_torch.data.png import read_png
    from sports_field_homography_tpu_torch.data.synthetic import write_synthetic_dataset

    torch.backends.cudnn.allow_tf32 = True      # the bf16 CLI's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    data = os.path.join(work, "pitch")
    t0 = time.perf_counter()
    tmpl = write_synthetic_dataset(data, 3 * BATCH, BATCH, PITCH_IMG, PITCH_POI,
                                   size=PITCH_WH, seed=1)
    labels = read_png(tmpl)
    if os.path.basename(tmpl) != "court_template_onehot.png" or \
            set(np.unique(labels)) != {0, 1, 2, 3}:
        raise AssertionError(f"pitch: the colour mask was not converted to labels 0..3: {tmpl}")
    log(f"pitch: wrote {4 * BATCH} synthetic {PITCH_WH[0]}x{PITCH_WH[1]} samples from the converted "
        f"{labels.shape[1]}x{labels.shape[0]} template in {time.perf_counter() - t0:.1f} s")
    size = list(PITCH_WH)
    conf = _train_conf(work, data, "pitch", court_img=tmpl, court_poi=PITCH_POI,
                       aug={"geometric": {"hflip": 0.5, "poi_flip_map": PITCH_FLIP}},
                       target_size=size, unet_size=size, warp_size=size, court_size=size)
    t0 = time.perf_counter()
    hist, launches = train_cli_counted(conf, "train pitch")
    secs = time.perf_counter() - t0
    steps = hist["steps"]
    if len(steps) != 3 or len(hist["validations"]) != 1:
        raise AssertionError(f"train pitch: {len(steps)} steps and "
                             f"{len(hist['validations'])} validations, expected 3 and 1")
    if not all(np.isfinite(v) for st in steps + hist["validations"] for v in st.values()):
        raise AssertionError(f"train pitch: a non-finite loss or score: {hist}")
    log(f"train pitch: losses " + "; ".join(", ".join(f"{k} {v:.5f}" for k, v in st.items())
                                           for st in steps)
        + f"; validation {json.dumps(hist['validations'][0])}; CLI total {secs:.1f} s [{card}]")

    ckpt = os.path.join(hist["cp_dir"], "CP_epoch1.pth")
    frames = os.path.join(data, "frames", "val_game")
    dst = os.path.join(work, "pitch_predict")
    stats = predict_cli.process(["--img_dir", frames, "--load", ckpt, "--dst_dir", dst,
                                 "--req_outputs", "theta,poi,consistency", "--batchsize",
                                 str(BATCH), "--court_img", tmpl, "--court_poi", PITCH_POI])
    with open(os.path.join(dst, "val_game_court.json")) as f:
        out = json.load(f)
    out.pop("model")
    poi = np.array([r["poi"] for r in out.values()])
    if len(out) != BATCH or poi.shape != (BATCH, 33, 2) or not np.isfinite(poi).all() or \
            not all(np.isfinite(r["score"]) and np.isfinite(r["theta"]).all()
                    for r in out.values()):
        raise AssertionError(f"predict pitch: {len(out)} records, poi {poi.shape}; expected "
                             f"{BATCH} finite records of 33 points")
    log(f"predict pitch: {len(out)} finite records of 33 points from {ckpt}; CLI loop "
        f"{stats['frames'] / stats['seconds']:.1f} frames/s [{card}]")

    class Args:
        target_size = unet_size = warp_size = court_size = PITCH_WH
        mask_classes = 4
        use_unet = use_resnet = use_warper = True
        unet_uv = unet_bilinear = False
        resnet_name, resnet_input = "resnet34", "img+mask"
        compute_dtype = "float32"
        court_img, court_poi = tmpl, PITCH_POI

    ds = BasicDataset(sorted(os.listdir(frames))[:2], frames, PITCH_WH)
    x = torch.from_numpy(np.stack([ds[i]["image"] for i in range(2)])).float() / 255.0
    res = {}
    for device in ("cuda", "cpu"):
        Args.device = device
        b = build_model(Args, load=ckpt, fold_bn=True)
        with torch.inference_mode():
            p = b.model.predict(x.to(b.device), b.court_labels, b.value_table,
                                court_poi=torch.from_numpy(b.court_poi).to(b.device))
        res[device] = {k: p[k].float().cpu() for k in ("theta", "consist_score", "poi")}
    gap = _output_gap(res["cuda"], res["cpu"])
    # a trained head's theta is not near unit size: its scale carries no
    # meaning (the homography is the same at any scale), so theta is
    # compared unit-normalized, as docs/PARITY.md compares trained thetas
    unit = {k: r["theta"].double() / r["theta"].double().flatten(1).norm(dim=1).view(-1, 1, 1, 1)
            for k, r in res.items()}
    d_unit = float((unit["cuda"] - unit["cpu"]).abs().max())
    log(f"pitch f32 CUDA vs CPU, 2 frames: unit-normalized theta max abs {d_unit:.3e} (bound "
        f"2e-4; raw theta {gap['theta']:.3e} at max |theta| "
        f"{float(res['cpu']['theta'].abs().max()):.3f}), score {gap['consist_score']:.3e} "
        f"(1e-3), poi {gap['poi']:.3e} (5e-4)")
    if not (d_unit <= 2e-4 and gap["consist_score"] <= 1e-3 and gap["poi"] <= 5e-4):
        raise AssertionError("pitch: f32 CUDA and CPU disagree beyond the bounds")
    torch.backends.cudnn.allow_tf32 = True
    return launches


VIDEO_WH = (1280, 720)         # the clip's frames and the CLI's out_size
VIDEO_TARGET = (640, 360)      # the flagship's input
VIDEO_FRAMES = 16
VIDEO_PARITY_FRAMES = 4
VIDEO_OUTPUTS = "segm_mask,warp_mask,theta,poi,consistency,debug"


def _write_clip(path, n, rng):
    """``n`` seeded 1280x720 frames as MJPG in an .avi (OpenCV's own codec,
    no FFmpeg backend needed): a smooth random pattern that moves, which
    the codec keeps.  Returns the writer's seconds."""
    import cv2

    w, h = VIDEO_WH
    base = rng.integers(0, 256, (h // 16, w // 16, 3), dtype=np.uint8)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (w, h))
    if not wr.isOpened():
        raise AssertionError(f"video: cv2.VideoWriter cannot open {path} for MJPG")
    for i in range(n):
        wr.write(cv2.resize(np.roll(base, i, axis=1), (w, h), interpolation=cv2.INTER_CUBIC))
    wr.release()
    return time.perf_counter() - t0


def _records(path):
    with open(path) as f:
        out = json.load(f)
    out.pop("model")
    return out


def phase_video_viz(dev, card, work):
    """BASELINE config #3 on the card, where cv2 imports: a clip of 16
    seeded 1280x720 frames (MJPG .avi) through the predict CLI with
    ``--video_path``, the debug renders and pickled segm masks, on phase
    predict's .pth (K1 once a batch on the full 1280x720 grid, every launch
    on its fast route); the f32 CUDA records of the first 4 frames against
    the CPU run's (theta 2e-4, score 1e-3, poi 5e-4 near the frame and
    relative to their distance beyond); the decode pool's and
    the writer's seconds; then ``cli.viz_preds`` on those records, with the
    threshold at the median score so that half the frames take the warp:
    K1 once a warped frame on the card, renders equal to the CPU's byte for
    byte, ``--no_encode`` unless an ``ffmpeg`` binary is on PATH.  Without
    cv2 it logs that it skipped."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        log("video and viz: skipped: cv2 does not import on this machine (the video source, "
            "the debug renders and viz_preds need it)")
        return None
    import torch

    from sports_field_homography_tpu_torch.cli import predict as predict_cli
    from sports_field_homography_tpu_torch.cli import viz_preds
    from sports_field_homography_tpu_torch.data.dataset import VideoDataset
    from sports_field_homography_tpu_torch.ops.bn_relu import bn_relu_norm
    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3
    from sports_field_homography_tpu_torch.ops.deconv import deconv2x2
    from sports_field_homography_tpu_torch.ops.warp import warp_nearest

    torch.backends.cudnn.allow_tf32 = True      # the bf16 CLI's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    root = os.path.join(work, "video")
    clip = os.path.join(root, "vgame", "clip.avi")
    write_s = _write_clip(clip, VIDEO_FRAMES, rng)
    short = os.path.join(root, "vgame4", "clip.avi")
    _write_clip(short, VIDEO_PARITY_FRAMES, np.random.default_rng(5))
    decode = {}
    for workers in (1, 4):
        ds = VideoDataset(clip, target_size=VIDEO_TARGET, keep_orig_img=True,
                          decode_workers=workers)
        t0 = time.perf_counter()
        got = [ds[i] for i in range(len(ds))]
        decode[workers] = time.perf_counter() - t0
        ds.close()
        if len(got) != VIDEO_FRAMES or got[-1]["orig_img"].shape != (VIDEO_WH[1], VIDEO_WH[0], 3):
            raise AssertionError(f"video: decoded {len(got)} frames, expected {VIDEO_FRAMES}")
    log(f"video: wrote {VIDEO_FRAMES} {VIDEO_WH[0]}x{VIDEO_WH[1]} MJPG frames in {write_s:.2f} s "
        f"({write_s * 1000 / VIDEO_FRAMES:.1f} ms a frame); decoded and resized to "
        f"{VIDEO_TARGET[0]}x{VIDEO_TARGET[1]} "
        f"sequentially in {decode[1]:.2f} s, by _VideoDecodePool (4 threads) in "
        f"{decode[4]:.2f} s ({decode[4] * 1000 / VIDEO_FRAMES:.1f} ms a frame)")

    ckpt = os.path.join(work, "flagship", "model.pth")
    base = ["--load", ckpt, "--court_img", COURT_IMG, "--court_poi", COURT_POI,
            "--out_size", str(VIDEO_WH[0]), str(VIDEO_WH[1])]
    dst = os.path.join(root, "out")
    kernels = {"warp_nearest": warp_nearest, "conv3x3": conv3x3, "deconv2x2": deconv2x2,
               "bn_relu_norm": bn_relu_norm}
    with recording_k1_grids() as grids:
        launches, stats = _counted(kernels, lambda: predict_cli.process(
            base + ["--video_path", clip, "--dst_dir", dst, "--req_outputs", VIDEO_OUTPUTS,
                    "--batchsize", str(BATCH), "--video_workers", "4"]), "video")
    if grids != [(VIDEO_WH[::-1], None)] * (VIDEO_FRAMES // BATCH) or \
            any(n <= 0 for n in launches.values()):
        raise AssertionError(f"video: K1 grids {grids}, launches {launches}: expected K1 once "
                             "a batch on the full 1280x720 grid and every kernel launched")
    recs = _records(os.path.join(dst, "vgame_court.json"))
    debug = sorted(os.listdir(os.path.join(dst, "court", "debug")))
    masks, n_masks = _read_pickle_masks(os.path.join(dst, "court", "segm_mask", "data.pkl"))
    names = [f"{i:06d}" for i in range(VIDEO_FRAMES)]
    if sorted(recs) != names or debug != [n + ".jpeg" for n in names] or \
            sorted(masks) != names or n_masks != VIDEO_FRAMES:
        raise AssertionError(f"video: {len(recs)} records, {len(debug)} debug renders, "
                             f"{n_masks} masks; expected {VIDEO_FRAMES} of each")
    shot = cv2.imread(os.path.join(dst, "court", "debug", debug[0]))
    if shot is None or shot.shape != (VIDEO_WH[1], VIDEO_WH[0], 3) or \
            masks[names[0]].shape != VIDEO_WH[::-1]:
        raise AssertionError("video: a debug render or a mask is not 1280x720")
    if not all(np.isfinite(r["theta"]).all() and np.isfinite(r["poi"]).all()
               and np.isfinite(r["score"]) for r in recs.values()):
        raise AssertionError("video: non-finite records")
    log(f"video: predict CLI bf16 over the clip: {stats['frames']} frames, launches "
        f"{launches}, K1 on {sorted(set(grids))}; {stats['frames'] / stats['seconds']:.1f} "
        f"frames/s with debug and masks, writer busy {stats['writer_seconds']:.2f} of "
        f"{stats['seconds']:.2f} s ({stats['writer_seconds'] * 1000 / stats['frames']:.1f} "
        f"ms a frame) [{card}]")

    out = {}
    for device in ("cuda", "cpu"):
        d = os.path.join(root, f"f32_{device}")
        predict_cli.process(base + ["--video_path", short, "--dst_dir", d, "--req_outputs",
                                    "theta,poi,consistency", "--batchsize", "2",
                                    "--compute_dtype", "float32", "--device", device])
        out[device] = _records(os.path.join(d, "vgame4_court.json"))
    gaps = {k: max(float(np.abs(np.asarray(out["cuda"][n][k]) - np.asarray(out["cpu"][n][k])
                                ).max()) for n in out["cpu"]) for k in ("theta", "score")}
    # the seeded head sends a few points tens of frame widths out, near the
    # horizon, where the perspective divide magnifies rounding: those are
    # held relative to their distance, the points within a frame of the
    # frame absolutely
    cpu = np.stack([np.asarray(out["cpu"][n]["poi"]) for n in sorted(out["cpu"])])
    cuda = np.stack([np.asarray(out["cuda"][n]["poi"]) for n in sorted(out["cpu"])])
    near = (np.abs(cpu - 0.5) <= 1.5).all(-1)
    d = np.abs(cuda - cpu).max(-1)
    gaps["poi"] = float(d[near].max())
    gaps["poi far"] = float((d[~near] / np.abs(cpu[~near]).max(-1)).max()) if (~near).any() \
        else 0.0
    log(f"video f32 CUDA vs CPU, {VIDEO_PARITY_FRAMES} frames: theta max abs "
        f"{gaps['theta']:.3e} (bound 2e-4), score {gaps['score']:.3e} (1e-3 plus the JSON's "
        f"rounding), poi within a frame of the frame {gaps['poi']:.3e} (5e-4), the "
        f"{int((~near).sum())} farther points (up to {float(np.abs(cpu).max()):.1f} frame "
        f"widths) {gaps['poi far']:.3e} of their distance (5e-4)")
    if sorted(out["cuda"]) != sorted(out["cpu"]) or len(out["cpu"]) != VIDEO_PARITY_FRAMES \
            or not (gaps["theta"] <= 2e-4 and gaps["score"] <= 1e-3 + 1e-6
                    and gaps["poi"] <= 5e-4 and gaps["poi far"] <= 5e-4):
        raise AssertionError("video: f32 CUDA and CPU records disagree beyond the bounds")
    torch.backends.cudnn.allow_tf32 = True

    # viz_preds over the bf16 records, half the frames below the threshold
    scores = sorted(r["score"] for r in recs.values())
    lo, hi = scores[VIDEO_FRAMES // 2 - 1], scores[VIDEO_FRAMES // 2]
    threshold = (lo + hi) / 2 if hi > lo else lo + 1e-6
    encode = shutil.which("ffmpeg") is not None
    argv = ["--video_path", clip, "--preds_path", os.path.join(dst, "vgame_court.json"),
            "--masks_path", os.path.join(dst, "court", "segm_mask", "data.pkl"),
            "--field_path", COURT_IMG, "--score_threshold", repr(threshold)]
    renders, viz_s = {}, {}
    for device in ("cuda", "cpu"):
        d = os.path.join(root, f"viz_{device}")
        warp_nearest.launches = warp_nearest.vec_launches = 0
        t0 = time.perf_counter()
        warped = viz_preds.main(argv + ["--dst_dir", d, "--device", device, "--no_encode"])
        viz_s[device] = time.perf_counter() - t0
        n_k1 = warp_nearest.launches
        if device == "cuda" and not (0 < warped and n_k1 == warped
                                     and warp_nearest.vec_launches == n_k1):
            raise AssertionError(f"viz: {warped} frames warped, K1 launched {n_k1} times "
                                 f"({warp_nearest.vec_launches} on the float4 route)")
        if device == "cpu" and n_k1:
            raise AssertionError("viz --device cpu launched K1")
        chunk = os.path.join(d, "_temp", "_chunk0")
        renders[device] = {f: open(os.path.join(chunk, f), "rb").read()
                           for f in sorted(os.listdir(chunk))}
    if sorted(renders["cuda"]) != [n + ".png" for n in names] or \
            any(renders["cpu"][f] != data for f, data in renders["cuda"].items()):
        raise AssertionError("viz: the CUDA renders differ from the CPU renders")
    log(f"viz: {warped} of {VIDEO_FRAMES} frames below the threshold {threshold:.6f} took K1 "
        f"({warped} launches, float4 route) at 1280x720; CUDA renders equal the CPU's byte for "
        f"byte; {viz_s['cuda'] * 1000 / VIDEO_FRAMES:.1f} ms a frame on the card, "
        f"{viz_s['cpu'] * 1000 / VIDEO_FRAMES:.1f} on the CPU (decode, overlay, PNG write) "
        f"[{card}]")
    if encode:
        d = os.path.join(root, "viz_encoded")
        viz_preds.main(argv + ["--dst_dir", d])
        if not os.path.isfile(os.path.join(d, "output.mp4")):
            raise AssertionError("viz: ffmpeg is on PATH but no output.mp4 was written")
        log("viz: ffmpeg encoded output.mp4")
    else:
        log("viz: no ffmpeg binary on PATH: rendered with --no_encode only")
    return launches


KERNEL_TABLE = [   # name, source, the TPU kernel it replaces
    ("warp_nearest", "warp_nearest.cu", "sports_field_homography_tpu/ops/warp_pallas.py:96"),
    ("conv3x3", "conv3x3_sm90.cu", "sports_field_homography_tpu/ops/conv3x3_pallas.py:151"),
    ("conv3x3_dual", "conv3x3_sm90.cu", "sports_field_homography_tpu/ops/conv3x3_pallas.py:157"),
    ("conv3x3_f32", "conv3x3.cu", "sports_field_homography_tpu/ops/conv3x3_pallas.py:151"),
    ("deconv2x2", "deconv2x2_sm90.cu", "sports_field_homography_tpu/ops/deconv_pallas.py:77"),
    ("deconv2x2_f32", "deconv2x2.cu", "sports_field_homography_tpu/ops/deconv_pallas.py:77"),
    ("deconv2x2_backward", "deconv2x2_sm90.cu",
     "sports_field_homography_tpu/ops/deconv_pallas.py:118"),
    ("deconv2x2_backward_f32", "deconv2x2.cu",
     "sports_field_homography_tpu/ops/deconv_pallas.py:118"),
    ("wgrad3x3", "wgrad3x3_sm90.cu", "sports_field_homography_tpu/ops/conv3x3_pallas.py:291"),
    ("wgrad3x3_f32", "wgrad3x3.cu", "sports_field_homography_tpu/ops/conv3x3_pallas.py:291"),
    ("bn_relu_bwd", "bn_relu_bwd.cu", "sports_field_homography_tpu/ops/bn_pallas.py:129"),
    ("bn_relu_bwd_split", "bn_relu_bwd.cu", "sports_field_homography_tpu/ops/bn_pallas.py:129"),
    ("bn_relu_stats", "bn_relu_fwd.cu", "sports_field_homography_tpu/ops/bn_pallas.py:109"),
    ("bn_relu_norm", "bn_relu_fwd.cu", "sports_field_homography_tpu/ops/bn_pallas.py:123"),
]


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, PKG)):
        print(f"chip_smoke: {PKG}/ not found beside this script; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch

    t_start = time.perf_counter()
    seconds = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        log(f"== phase {name}: {seconds[name]:.1f} s")
        return out

    card = run("device", phase_device)
    dev = torch.device("cuda:0")
    run("build", phase_build)
    kres = run("kernels", phase_kernels, dev, card)
    kres.update(run("train kernels", phase_train_kernels, dev, card))
    kres.update(run("K7-fwd and two-input K2", phase_fwd_kernels, dev, card))
    kres.update(run("K2, K5, K3 and K7-bwd levels", phase_levels, dev, card))
    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    # launches: the predict path's kernels from the deconv predict run, the
    # training kernels from the deconv train run
    launches = run("predict", phase_predict, dev, card, work)
    # K1's launches: the full-output run, where it warps the full grid
    launches["warp_nearest"] = run("predict full outputs", phase_predict_full, dev, card,
                                   work)["warp_nearest"]
    train_launches, cp_dir, data = run("train", phase_train, dev, card, work)
    launches.update({k: train_launches[k] for k in
                     ("deconv2x2_backward", "wgrad3x3", "bn_relu_bwd", "bn_relu_stats")})
    dp = run("data parallel", phase_data_parallel, dev, card, work)
    launches["bn_relu_bwd_split"] = dp.pop("launches")
    kres["bn_relu_bwd_split"] = dp
    launches.update(run("train parity", phase_train_parity))
    run("predict bilinear", phase_predict, dev, card, work, True)
    run("train bilinear", phase_train, dev, card, work, True)
    run("train parity bilinear", phase_bilinear_parity)
    run("test CLI", phase_test_cli, dev, card, work, cp_dir, data)
    run("train example conf", phase_train_example, dev, card, work)
    run("predict resnet50", phase_predict_resnet50, dev, card)
    run("serve", phase_serve, dev, card, work)
    run("serve artifact", phase_serve_artifact, dev, card, work)
    run("legacy", phase_legacy, dev, card)
    run("pitch", phase_pitch, dev, card, work)
    run("video and viz", phase_video_viz, dev, card, work)
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
        + f"; total {time.perf_counter() - t_start:.1f} s")

    kernels = [dict({"name": name, "route": "cuda", "source": f"{PKG}/csrc/{fname}",
                     "replaces": replaces, "launches": launches[name]}, **kres[name])
               for name, fname, replaces in KERNEL_TABLE]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
