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
     K1 warp      1280x720 template, full grid and sample_hw=(360, 640):
                  labels equal;
     K2 conv3x3   64->64 at 360x640 and 128->128 at 180x320, with and
                  without the prologue;
     K3 deconv    the four UNet up-convs;
     K2+stats     64->64 at 360x640 with the prologue, 1024->512 at 45x80;
     K5 wgrad     64->64 at 360x640 with and without the prologue, 128->128
                  at 180x320, 1024->512 at 45x80;
     K7-bwd       360x640x64;
     K3-bwd       up4 (180x320x128 -> 64) and up1 (22x40x1024 -> 512);
     K7-fwd       stats of 360x640x64 (f32, the stem's output, and bf16),
                  norm of 360x640x64 (f32: equal bit for bit; bf16);
     K2 two-input 64+64->64 at 360x640 (up4 conv1) and 512+512->512 at
                  45x80 (the bilinear up1 conv1), with and without stats.
   In f32 with TF32 off (elementwise outputs rtol = atol = 1e-4;
   reductions, whose kernels sum in another order, rel-L2 <= 1e-5 against
   the plain version in float64 on the same inputs), and in bf16 against
   the plain version on the same bf16 inputs, which like the kernels
   accumulates in f32 (rtol = atol = 2e-2; reductions rel-L2 <= 1e-3).
   Every reduction kernel is run twice and must repeat bitwise.
4. predict: 16 seeded 640x360 PNG frames, a seeded resnet34 img+mask model
   saved as .pth, the predict CLI in-process (bf16, theta + consistency,
   batch 8, NCAA court).  Checks 16 finite records and that K1, K2 (one-
   and two-input), K3 and K7-fwd's norm launched; then 2 frames in f32 on
   CUDA (TF32 off) against the CPU (plain versions): theta max-abs <=
   2e-4, score <= 1e-3.  Prints the device time of a batch of 8.
5. train: a seeded synthetic 640x360 set (24 train, 8 validation frames),
   a JSON conf (the flagship, bf16, the example conf's losses and RMSprop,
   consist_start_iter 0), the train CLI in-process: 3 steps at batch 8 and
   one validation pass.  Checks finite losses, that K2 (with stats, two-
   input, as dgrad), K3, K3-bwd, K5, K7-fwd (stats, norm) and K7-bwd
   launched, and that the written .pth loads into the predict CLI.  Prints
   ms/step and img/s at batch 8.
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

The last two lines are JSON: the kernel table (each kernel's launches in
the deconv predict run, or for the training kernels the deconv train run;
its error, times and bound), then ``{"ok": true, "device": {...}}``.
"""
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

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


def phase_kernels(dev, card):
    """Each kernel against its plain version at the path's shapes."""
    import torch
    import torch.nn.functional as F

    from sports_field_homography_tpu_torch.data.assets import open_court_template
    from sports_field_homography_tpu_torch.geometry.warp import subsampled_warp_grid
    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain
    from sports_field_homography_tpu_torch.ops.deconv import deconv2x2, deconv2x2_plain
    from sports_field_homography_tpu_torch.ops.warp import (
        template_value_step, warp_nearest, warp_nearest_plain)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    # --- K1: nearest warp -------------------------------------------------
    labels_np = open_court_template(COURT_IMG, 4, size=(1280, 720))
    labels = torch.from_numpy(labels_np).to(dev)
    step = template_value_step(labels_np, 4)
    eye = torch.eye(3, device=dev).expand(BATCH, 3, 3)
    noise = torch.randn((BATCH, 3, 3), generator=gen, device=dev)
    theta = eye + noise * torch.tensor([[0.1, 0.1, 0.2], [0.1, 0.1, 0.2],
                                        [0.05, 0.05, 0.0]], device=dev)
    k1_err, k1_ms = 0.0, None
    for sample in (None, (360, 640)):
        got = warp_nearest(labels, theta, (720, 1280), sample_hw=sample, value_step=step)
        ref = warp_nearest_plain(labels, theta, (720, 1280), sample_hw=sample, value_step=step)
        torch.cuda.synchronize()
        n_diff = int((got != ref).sum().item())
        covered = float((got > 0).float().mean().item())
        if n_diff:
            raise AssertionError(f"K1 warp sample_hw={sample}: {n_diff} labels differ")
        ms = cuda_ms(lambda: warp_nearest(labels, theta, (720, 1280), sample, step))
        pms = cuda_ms(lambda: warp_nearest_plain(labels, theta, (720, 1280), sample, step))
        log(f"K1 warp_nearest 1280x720 sample_hw={sample} B={BATCH}: labels equal "
            f"({got.numel()} samples, {covered:.1%} on the court); "
            f"kernel {ms:.4f} ms, plain {pms:.4f} ms [{card}]")
        if sample is not None:
            k1_ms = (ms, pms)
            bnd = bound(0, nbytes(labels, theta, got))
    # yardstick: F.grid_sample(nearest) of the float template at the same
    # sample points (grid made beforehand, not timed)
    grid = subsampled_warp_grid(theta, (720, 1280), (360, 640))
    tmpl = labels.float().expand(BATCH, 1, 720, 1280).contiguous()
    lib = cuda_ms(lambda: F.grid_sample(tmpl, grid, mode="nearest", align_corners=False))
    log(f"K1 library F.grid_sample(nearest) at the sampled grid: {lib:.4f} ms; bound "
        f"{bnd[0]:.4f} ms ({bnd[1]}) [{card}]")
    results["warp_nearest"] = entry(k1_err, *k1_ms, lib, bnd)
    del tmpl, grid

    # --- K2: conv3x3 ------------------------------------------------------
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
            got = conv3x3(x32, wt, b, prologue)
            err = _compare(f"K2 f32 {tag}", got, conv3x3_plain(x32, wt, b, prologue), 1e-4, 1e-4)
            ms = cuda_ms(lambda: conv3x3(x32, wt, b, prologue))
            pms = cuda_ms(lambda: conv3x3_plain(x32, wt, b, prologue))
            log(f"K2 conv3x3 f32 {tag}: max abs err {err:.2e}; kernel {ms:.3f} ms, "
                f"plain (cuDNN f32) {pms:.3f} ms [{card}]")
            xb, wb = x32.bfloat16(), wt.bfloat16()
            got = conv3x3(xb, wb, b, prologue)
            ref = conv3x3_plain(xb.float(), wb.float(), b, prologue)
            errb = _compare(f"K2 bf16 {tag}", got, ref, 2e-2, 2e-2)
            ms_b = cuda_ms(lambda: conv3x3(xb, wb, b, prologue))
            pms_b = cuda_ms(lambda: conv3x3_plain(xb, wb, b, prologue))
            log(f"K2 conv3x3 bf16 {tag}: max abs err vs f32 {errb:.2e}; kernel "
                f"{ms_b:.3f} ms, plain (cuDNN) {pms_b:.3f} ms [{card}]")
            k2_err = max(k2_err, err, errb)
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

    # --- K3: deconv k2s2 --------------------------------------------------
    k3_err, k3_ms, k3_pms, k3_lib, k3_flops, k3_bytes = 0.0, 0.0, 0.0, 0.0, 0.0, 0
    for (h, w, cin) in ((22, 40, 1024), (45, 80, 512), (90, 160, 256), (180, 320, 128)):
        cout = cin // 2
        x32 = torch.randn((BATCH, h, w, cin), generator=gen, device=dev)
        wt = torch.randn((cin, 2, 2, cout), generator=gen, device=dev) / cin ** 0.5
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1
        tag = f"{cin}->{cout} {h}x{w}->{2 * h}x{2 * w}"
        err = _compare(f"K3 f32 {tag}", deconv2x2(x32, wt, b),
                       deconv2x2_plain(x32, wt, b), 1e-4, 1e-4)
        xb, wb = x32.bfloat16(), wt.bfloat16()
        errb = _compare(f"K3 bf16 {tag}", deconv2x2(xb, wb, b),
                        deconv2x2_plain(xb.float(), wb.float(), b), 2e-2, 2e-2)
        ms = cuda_ms(lambda: deconv2x2(xb, wb, b))
        pms = cuda_ms(lambda: deconv2x2_plain(xb, wb, b))
        wt_io = wb.permute(0, 3, 1, 2).contiguous()          # (Cin, Cout, 2, 2)
        lib = cuda_ms(lambda: F.conv_transpose2d(nchw(xb), wt_io, b.bfloat16(), stride=2))
        log(f"K3 deconv2x2 {tag}: max abs err f32 {err:.2e}, bf16 vs f32 {errb:.2e}; "
            f"bf16 kernel {ms:.3f} ms, plain (cuDNN) {pms:.3f} ms, library "
            f"F.conv_transpose2d {lib:.3f} ms [{card}]")
        k3_err = max(k3_err, err, errb)
        k3_ms += ms
        k3_pms += pms
        k3_lib += lib
        k3_flops += 2.0 * BATCH * h * w * cin * 4 * cout
        k3_bytes += nbytes(xb, wb) + BATCH * 4 * h * w * cout * 2
    bnd = bound(k3_flops, k3_bytes)
    log(f"K3 deconv2x2 all four up-convs, bf16: kernel {k3_ms:.3f} ms, plain {k3_pms:.3f} ms, "
        f"library {k3_lib:.3f} ms; bound {bnd[0]:.3f} ms ({bnd[1]})")
    results["deconv2x2"] = entry(k3_err, k3_ms, k3_pms, k3_lib, bnd)
    return results


def _predict_launches(kernels):
    """Launch counts of the predict path's kernels, K2's single- and
    two-input launches apart."""
    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3

    launches = {name: fn.launches for name, fn in kernels.items()}
    launches["conv3x3_dual"] = conv3x3.dual_launches
    launches["conv3x3"] -= conv3x3.dual_launches
    return launches


def phase_predict(dev, card, work, bilinear=False):
    """The predict CLI on 16 seeded frames (deconv or bilinear UNet), f32
    CUDA against the CPU on 2 frames, and the device time of a batch."""
    import torch

    from sports_field_homography_tpu_torch.cli import predict as predict_cli
    from sports_field_homography_tpu_torch.cli.engine import build_model
    from sports_field_homography_tpu_torch.data.dataset import BasicDataset
    from sports_field_homography_tpu_torch.data.png import write_png
    from sports_field_homography_tpu_torch.models import Reconstructor, ReconstructorConfig
    from sports_field_homography_tpu_torch.models.layers import init_weights
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
    model = Reconstructor(ReconstructorConfig(resnet_name="resnet34", resnet_input="img+mask",
                                              unet_bilinear=bilinear))
    gen = torch.Generator().manual_seed(0)
    init_weights(model, gen)
    with torch.no_grad():      # fresh init regresses identity: vary theta
        model.resnet_reg.reg.weight.copy_(
            torch.randn(model.resnet_reg.reg.weight.shape, generator=gen) * 5e-3)
    ckpt = os.path.join(work, variant, "model.pth")
    os.makedirs(os.path.dirname(ckpt))
    torch.save(model.state_dict(), ckpt)
    dst = os.path.join(work, f"out_{variant}")
    flag = ["--unet_bilinear"] if bilinear else []

    kernels = {"warp_nearest": warp_nearest, "conv3x3": conv3x3, "deconv2x2": deconv2x2,
               "bn_relu_norm": bn_relu_norm}
    for fn in kernels.values():
        fn.launches = 0
    conv3x3.dual_launches = 0
    stats = predict_cli.process(
        ["--img_dir", frames, "--load", ckpt, "--dst_dir", dst,
         "--req_outputs", "theta,consistency", "--batchsize", str(BATCH),
         "--court_img", COURT_IMG, "--court_poi", COURT_POI] + flag)
    launches = _predict_launches(kernels)
    log(f"predict {variant}: kernel launches in the CLI run: {launches}")
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
        with torch.inference_mode():
            p = b.model.predict(x.to(b.device), b.court_labels, b.value_step)
        res[device] = {k: p[k].float().cpu() for k in ("theta", "consist_score")}
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
            b.model.predict(xb.float() / 255.0, b.court_labels, b.value_step)

    ms = cuda_ms(step, warmup=2, runs=5)
    log(f"predict {variant}: theta+consistency 640x360 bf16 batch {BATCH}: {ms:.2f} ms/batch, "
        f"{BATCH * 1000.0 / ms:.1f} frames/s (CUDA events, median of 5) [{card}]")
    return launches


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
        y, s = conv3x3(x, wt, b, pro, stats=True)
        y_ref, _ = conv3x3_plain(x, wt, b, pro, stats=True)
        _, s64 = conv3x3_plain(x.double(), wt.double(), b.double(), as64(pro), stats=True)
        e = _compare(f"K2+stats f32 {tag}", y, y_ref, 1e-4, 1e-4)
        r = _reduction(f"K2+stats f32 sums {tag}", s, s64, 1e-5)
        xb, wb = x.bfloat16(), wt.bfloat16()
        yb, sb = conv3x3(xb, wb, b, pro, stats=True)
        yb_ref, sb_ref = conv3x3_plain(xb, wb, b, pro, stats=True)
        eb = _compare(f"K2+stats bf16 {tag}", yb, yb_ref, 2e-2, 2e-2)
        rb = _reduction(f"K2+stats bf16 sums {tag}", sb, sb_ref, 1e-3)
        rep = _repeats_bitwise(f"K2+stats {tag}", lambda: conv3x3(xb, wb, b, pro, stats=True))
        ms = cuda_ms(lambda: conv3x3(xb, wb, b, pro, stats=True))
        pms = cuda_ms(lambda: conv3x3_plain(xb, wb, b, pro, stats=True))
        log(f"K2+stats conv3x3 {tag}: f32 max abs err {e:.2e}, sums rel-L2 {r:.2e} "
            f"(vs float64); bf16 max abs err {eb:.2e}, sums rel-L2 {rb:.2e}; {rep}; "
            f"bf16 kernel {ms:.3f} ms, plain (f32 cuDNN conv + sums) {pms:.3f} ms [{card}]")
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
        dw, db = wgrad3x3(x, dy, pro)
        dw64, db64 = wgrad3x3_plain(x.double(), dy.double(), as64(pro))
        r = max(_reduction(f"K5 f32 dW {tag}", dw, dw64, 1e-5),
                _reduction(f"K5 f32 db {tag}", db, db64, 1e-5))
        r_plain = _rel_l2(wgrad3x3_plain(x, dy, pro)[0], dw64)
        xb, dyb = x.bfloat16(), dy.bfloat16()
        dwb, dbb = wgrad3x3(xb, dyb, pro)
        dwb_ref, dbb_ref = wgrad3x3_plain(xb, dyb, pro)
        rb = max(_reduction(f"K5 bf16 dW {tag}", dwb, dwb_ref, 1e-3),
                 _reduction(f"K5 bf16 db {tag}", dbb, dbb_ref, 1e-3))
        e = max(float((dw - dw64).abs().max()), float((dwb - dwb_ref).abs().max()))
        rep = _repeats_bitwise(f"K5 {tag}", lambda: wgrad3x3(xb, dyb, pro))
        ms = cuda_ms(lambda: wgrad3x3(xb, dyb, pro))
        pms = cuda_ms(lambda: wgrad3x3_plain(xb, dyb, pro))
        log(f"K5 wgrad3x3 {tag}: f32 rel-L2 {r:.2e} vs float64 (plain f32 cuDNN "
            f"{r_plain:.2e}); bf16 rel-L2 {rb:.2e}; {rep}; bf16 kernel {ms:.3f} ms, "
            f"plain (cuDNN wgrad) {pms:.3f} ms [{card}]")
        err = max(err, e)
        if timing is None:      # the line's case: no prologue, as the library call
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
    dx, dgam, dbet = bn_relu_bwd(y, g, *vecs)
    dx_ref, _, _ = bn_relu_bwd_plain(y, g, *vecs)
    _, dgam64, dbet64 = bn_relu_bwd_plain(y.double(), g.double(), *map(lambda v: v.double(), vecs))
    e = _compare("K7-bwd f32 dx", dx, dx_ref, 1e-4, 1e-4)
    r = max(_reduction("K7-bwd f32 dgamma", dgam, dgam64, 1e-5),
            _reduction("K7-bwd f32 dbeta", dbet, dbet64, 1e-5))
    yb, gb = y.bfloat16(), g.bfloat16()
    dxb, dgamb, dbetb = bn_relu_bwd(yb, gb, *vecs)
    dxb_ref, dgamb_ref, dbetb_ref = bn_relu_bwd_plain(yb, gb, *vecs)
    eb = _compare("K7-bwd bf16 dx", dxb, dxb_ref, 2e-2, 2e-2)
    rb = max(_reduction("K7-bwd bf16 dgamma", dgamb, dgamb_ref, 1e-3),
             _reduction("K7-bwd bf16 dbeta", dbetb, dbetb_ref, 1e-3))
    rep = _repeats_bitwise("K7-bwd", lambda: bn_relu_bwd(yb, gb, *vecs))
    ms = cuda_ms(lambda: bn_relu_bwd(yb, gb, *vecs))
    pms = cuda_ms(lambda: bn_relu_bwd_plain(yb, gb, *vecs))
    # yardstick: the autograd of relu(F.batch_norm(training=True)) on the
    # same bf16 input (its forward made beforehand, not timed)
    yl = nchw(yb).detach().requires_grad_()
    gl, bl = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
    out = torch.relu(F.batch_norm(yl, None, None, gl, bl, training=True, eps=1e-5))
    gn = nchw(gb)
    lib = cuda_ms(lambda: torch.autograd.grad(out, (yl, gl, bl), gn, retain_graph=True))
    bnd = bound(0, nbytes(yb, gb, dxb))
    log(f"K7-bwd bn_relu_bwd 360x640x{c}: f32 dx max abs err {e:.2e}, sums rel-L2 "
        f"{r:.2e} (vs float64); bf16 dx max abs err {eb:.2e}, sums rel-L2 {rb:.2e}; "
        f"{rep}; bf16 kernel {ms:.3f} ms, plain (torch elementwise + sums) {pms:.3f} ms, "
        f"library (autograd of F.batch_norm + ReLU) {lib:.3f} ms; bound {bnd[0]:.3f} ms "
        f"({bnd[1]}) [{card}]")
    results["bn_relu_bwd"] = entry(max(e, eb), ms, pms, lib, bnd)
    del out, yl, gn
    del y, g, dx, dx_ref, yb, gb, dxb, dxb_ref

    # --- K3-bwd ------------------------------------------------------------
    err, timing = 0.0, None
    for (h, w, cin) in ((180, 320, 128), (22, 40, 1024)):
        cout = cin // 2
        x = rnd(BATCH, h, w, cin)
        dy = rnd(BATCH, 2 * h, 2 * w, cout)
        wt = rnd(cin, 2, 2, cout, scale=cin ** -0.5)
        tag = f"{cin}->{cout} {h}x{w}->{2 * h}x{2 * w}"
        dx, dw, db = deconv2x2_backward(x, dy, wt)
        dx_ref, _, _ = deconv2x2_backward_plain(x, dy, wt)
        _, dw64, db64 = deconv2x2_backward_plain(x.double(), dy.double(), wt.double())
        e = _compare(f"K3-bwd f32 dx {tag}", dx, dx_ref, 1e-4, 1e-4)
        r = max(_reduction(f"K3-bwd f32 dW {tag}", dw, dw64, 1e-5),
                _reduction(f"K3-bwd f32 db {tag}", db, db64, 1e-5))
        xb, dyb, wb = x.bfloat16(), dy.bfloat16(), wt.bfloat16()
        dxb, dwb, dbb = deconv2x2_backward(xb, dyb, wb)
        dxb_ref, dwb_ref, dbb_ref = deconv2x2_backward_plain(xb, dyb, wb)
        eb = _compare(f"K3-bwd bf16 dx {tag}", dxb, dxb_ref, 2e-2, 2e-2)
        rb = max(_reduction(f"K3-bwd bf16 dW {tag}", dwb, dwb_ref, 1e-3),
                 _reduction(f"K3-bwd bf16 db {tag}", dbb, dbb_ref, 1e-3))
        rep = _repeats_bitwise(f"K3-bwd {tag}", lambda: deconv2x2_backward(xb, dyb, wb))
        ms = cuda_ms(lambda: deconv2x2_backward(xb, dyb, wb))
        pms = cuda_ms(lambda: deconv2x2_backward_plain(xb, dyb, wb))
        log(f"K3-bwd deconv2x2_backward {tag}: f32 dx max abs err {e:.2e}, dW/db rel-L2 "
            f"{r:.2e} (vs float64); bf16 dx max abs err {eb:.2e}, dW/db rel-L2 {rb:.2e}; "
            f"{rep}; bf16 kernel {ms:.3f} ms, plain (cuDNN dgrad + f32 einsum) "
            f"{pms:.3f} ms [{card}]")
        err = max(err, e, eb)
        if timing is None:
            # yardstick: the autograd of F.conv_transpose2d (forward not timed)
            xl = nchw(xb).detach().requires_grad_()
            wl = wb.permute(0, 3, 1, 2).contiguous().requires_grad_()
            bl = torch.zeros(cout, device=dev, dtype=torch.bfloat16, requires_grad=True)
            out = F.conv_transpose2d(xl, wl, bl, stride=2)
            dyn = nchw(dyb)
            lib = cuda_ms(lambda: torch.autograd.grad(out, (xl, wl, bl), dyn,
                                                      retain_graph=True))
            bnd = bound(2 * 2.0 * BATCH * h * w * cin * 4 * cout,
                        nbytes(xb, dyb, wb, dxb, dwb, dbb))
            log(f"K3-bwd library (autograd of F.conv_transpose2d) {tag}: {lib:.3f} ms; "
                f"bound {bnd[0]:.3f} ms ({bnd[1]}) [{card}]")
            timing = (ms, pms, lib, bnd)
            del out, xl, dyn
        del x, dy, dx, dx_ref, xb, dyb, dxb, dxb_ref
    results["deconv2x2_backward"] = entry(err, *timing)
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
        y, st = conv3x3(a, wa, bias, stats=True, x2=b, w2=wb)
        e = _compare(f"K2 two-input f32 {tag}", y,
                     conv3x3_plain(a, wa, bias, x2=b, w2=wb), 1e-4, 1e-4)
        _, s64 = conv3x3_plain(a.double(), wa.double(), bias.double(), stats=True,
                               x2=b.double(), w2=wb.double())
        r = _reduction(f"K2 two-input f32 sums {tag}", st, s64, 1e-5)
        ab, bb, wab, wbb = a.bfloat16(), b.bfloat16(), wa.bfloat16(), wb.bfloat16()
        yb, sb = conv3x3(ab, wab, bias, stats=True, x2=bb, w2=wbb)
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


def phase_train(dev, card, work, bilinear=False):
    """The train CLI through the training kernels (deconv or bilinear
    UNet), its checkpoint through the predict CLI, and the step time."""
    import torch

    from sports_field_homography_tpu_torch.cli import predict as predict_cli
    from sports_field_homography_tpu_torch.cli import train as train_cli
    from sports_field_homography_tpu_torch.data.synthetic import write_synthetic_dataset
    from sports_field_homography_tpu_torch.ops.bn_relu import bn_relu_norm, bn_relu_stats
    from sports_field_homography_tpu_torch.ops.bn_relu_bwd import bn_relu_bwd
    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3
    from sports_field_homography_tpu_torch.ops.deconv import deconv2x2, deconv2x2_backward
    from sports_field_homography_tpu_torch.ops.wgrad3x3 import wgrad3x3

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

    counters = {"conv3x3": conv3x3, "deconv2x2": deconv2x2,
                "deconv2x2_backward": deconv2x2_backward, "wgrad3x3": wgrad3x3,
                "bn_relu_bwd": bn_relu_bwd, "bn_relu_stats": bn_relu_stats,
                "bn_relu_norm": bn_relu_norm}
    for fn in counters.values():
        fn.launches = 0
    conv3x3.stats_launches = conv3x3.dual_launches = 0
    t0 = time.perf_counter()
    hist = train_cli.main(["-c", conf])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    launches["conv3x3_stats"] = conv3x3.stats_launches
    launches["conv3x3_dual"] = conv3x3.dual_launches
    log(f"train {variant}: kernel launches in the CLI run: {launches}")
    deconv_only = ("deconv2x2", "deconv2x2_backward")
    for name, n in launches.items():
        if n <= 0 and not (bilinear and name in deconv_only):
            raise AssertionError(f"train {variant}: {name} was never launched by the path")
    if bilinear and any(launches[k] for k in deconv_only):
        raise AssertionError("train bilinear: K3 or K3-bwd was launched by the bilinear UNet")
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

    kw = dict(seed=seed, bilinear=bilinear)
    (lg, gg, _), (lc, gc, _), (_, g64, _), (_, gu, _) = (
        parity_step("cuda", **kw), parity_step("cpu", **kw),
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
        + ", ".join(f"{d} worst {w:.3e} median {m:.3e}" for d, (w, _, m, _) in to64.items()))


def phase_train_parity():
    """f32 CUDA-vs-CPU parity of the train step and of its UNet modules."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    _step_parity("train parity")
    # every UNet module of that step, and of steps at larger and odd sizes,
    # replayed from the same inputs and cotangent on CUDA and in float64
    for size, b in (((64, 36), 3), ((128, 72), 3), ((256, 144), 2)):
        _module_replay(size, b, 5)
    torch.backends.cudnn.deterministic = False


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
    from sports_field_homography_tpu_torch.models import reconstructor
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
    grids = []
    k1 = reconstructor.warp_nearest

    def recording_k1(labels, theta, out_hw, sample_hw=None, value_step=1.0):
        grids.append((tuple(out_hw), sample_hw))
        return k1(labels, theta, out_hw, sample_hw, value_step)

    kernels = {"warp_nearest": warp_nearest, "conv3x3": conv3x3, "deconv2x2": deconv2x2,
               "bn_relu_norm": bn_relu_norm}
    for fn in kernels.values():
        fn.launches = 0
    conv3x3.dual_launches = 0
    reconstructor.warp_nearest = recording_k1
    try:
        res = test_cli.main(argv + ["--device", "cuda"])["1"]
    finally:
        reconstructor.warp_nearest = k1
    launches = _predict_launches(kernels)
    log(f"test CLI: kernel launches in the run: {launches}; K1 grids {sorted(set(grids))}")
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

    f32 = {d: test_cli.main(argv + ["--device", d, "--compute_dtype", "float32"])["1"]
           for d in ("cuda", "cpu")}
    worst = max(abs(f32["cuda"][k] - f32["cpu"][k]) / max(abs(f32["cpu"][k]), 1e-30)
                for k in keys)
    log("test CLI f32 CUDA vs CPU: " + ", ".join(
        f"{k} {f32['cuda'][k]:.6g} / {f32['cpu'][k]:.6g}" for k in keys)
        + f"; worst rel diff {worst:.3e} (bound 1e-3)")
    if not worst <= 1e-3:
        raise AssertionError("test CLI: f32 CUDA and CPU scores differ beyond rtol 1e-3")
    return launches


def flagship_train_step(dev, batch_size, bilinear=False):
    """A closure running one flagship (or bilinear-UNet) bf16 train step
    (seeded random weights) on a fixed batch of synthetic 640x360 court
    renders."""
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
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    court = (torch.from_numpy(open_court_template(COURT_IMG, 4, size=(640, 360)))
             .float().to(dev) / 4)
    poi = torch.from_numpy(load_court_poi(COURT_POI).astype(np.float32)).to(dev)
    cfg = LossConfig(seg_loss="focal", rec_loss="MSE", reproj_loss="RRMSE",
                     consist_loss="focal", seg_lambda=1.0, rec_lambda=1.0,
                     reproj_lambda=8.0, consist_lambda=1.0, batch_size=b)
    opt = make_optimizer("RMSprop", model.parameters(), 1e-4, 1e-6)
    return lambda: train_step(model, opt, batch, 0, court, poi, cfg)


def flagship_predict_step(dev, batch_size, bilinear=False):
    """A closure running the flagship's (or the bilinear UNet's) predict
    path as the predict CLI does (bf16, BN folded, theta + consistency on
    the 1280x720 NCAA warp grid sampled at the logits) on a fixed batch of
    seeded uint8 640x360 frames, with seeded random weights."""
    import torch

    from sports_field_homography_tpu_torch.data.assets import open_court_template
    from sports_field_homography_tpu_torch.models import Reconstructor, ReconstructorConfig
    from sports_field_homography_tpu_torch.models.layers import init_weights
    from sports_field_homography_tpu_torch.ops.fold_bn import fold_batchnorm
    from sports_field_homography_tpu_torch.ops.warp import template_value_step

    model = Reconstructor(ReconstructorConfig(warp_size=(1280, 720), unet_bilinear=bilinear),
                          dtype=torch.bfloat16)
    init_weights(model, torch.Generator().manual_seed(0))
    model = fold_batchnorm(model).to(dev).eval()
    labels_np = open_court_template(COURT_IMG, 4, size=(1280, 720))
    labels, step = torch.from_numpy(labels_np).to(dev), template_value_step(labels_np, 4)
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (batch_size, 360, 640, 3), dtype=np.uint8)).to(dev)

    def run():
        with torch.inference_mode():
            return model.predict(frames.float() / 255.0, labels, step)

    return run


KERNEL_TABLE = [   # name, source, the TPU kernel it replaces
    ("warp_nearest", "warp_nearest.cu", "sports_field_homography_tpu/ops/warp_pallas.py:96"),
    ("conv3x3", "conv3x3.cu", "sports_field_homography_tpu/ops/conv3x3_pallas.py:151"),
    ("conv3x3_dual", "conv3x3.cu", "sports_field_homography_tpu/ops/conv3x3_pallas.py:157"),
    ("deconv2x2", "deconv2x2.cu", "sports_field_homography_tpu/ops/deconv_pallas.py:77"),
    ("deconv2x2_backward", "deconv2x2.cu", "sports_field_homography_tpu/ops/deconv_pallas.py:118"),
    ("wgrad3x3", "wgrad3x3.cu", "sports_field_homography_tpu/ops/conv3x3_pallas.py:291"),
    ("bn_relu_bwd", "bn_relu_bwd.cu", "sports_field_homography_tpu/ops/bn_pallas.py:129"),
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
    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    # launches: the predict path's kernels from the deconv predict run, the
    # training kernels from the deconv train run
    launches = run("predict", phase_predict, dev, card, work)
    train_launches, cp_dir, data = run("train", phase_train, dev, card, work)
    launches.update({k: train_launches[k] for k in
                     ("deconv2x2_backward", "wgrad3x3", "bn_relu_bwd", "bn_relu_stats")})
    run("train parity", phase_train_parity)
    run("predict bilinear", phase_predict, dev, card, work, True)
    run("train bilinear", phase_train, dev, card, work, True)
    run("train parity bilinear", phase_bilinear_parity)
    run("test CLI", phase_test_cli, dev, card, work, cp_dir, data)
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
