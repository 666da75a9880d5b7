#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sports_field_homography_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:

1. device: a CUDA device must be present; prints the card's name and power
   limit as ``nvidia-smi`` reports them.
2. build: compiles the CUDA kernels from ``csrc/`` (``build/torch_kernels/``).
3. kernels: each kernel against its plain PyTorch version on the card, at
   the predict path's shapes with batch 8, timed with CUDA events (median
   of several runs):
     K1 warp      1280x720 template, full grid and sample_hw=(360, 640):
                  labels equal;
     K2 conv3x3   64->64 at 360x640 and 128->128 at 180x320, with and
                  without the prologue;
     K3 deconv    the four UNet up-conv shapes;
   K2/K3 in f32 with TF32 off (rtol = atol = 1e-4), and in bf16 against
   the plain version in f32 on the same bf16 inputs (rtol = atol = 2e-2).
4. slice: 16 seeded 640x360 PNG frames, a seeded resnet34 img+mask model
   saved as .pth, the predict CLI in-process (bf16, theta + consistency,
   batch 8, NCAA court).  Checks 16 finite records and that every kernel
   of the path launched; then 2 frames in f32 on CUDA (TF32 off) against
   the CPU (plain versions): theta max-abs <= 2e-4, score <= 1e-3.  Prints
   the slice's frames/s at batch 8.

The last two lines are JSON: the kernel table, then
``{"ok": true, "device": {...}}``.
"""
import json
import os
import shutil
import statistics
import struct
import subprocess
import sys
import time
import zlib

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "sports_field_homography_tpu_torch"
BATCH = 8
COURT_IMG = os.path.join(REPO, "assets", "mask_ncaa_v4_nc4_m_onehot.png")
COURT_POI = os.path.join(REPO, "assets", "template_ncaa_v4_points.json")


def log(msg: str) -> None:
    print(msg, flush=True)


def write_png(path: str, rgb: np.ndarray) -> None:
    """Minimal 8-bit RGB PNG writer (filter 0), so the smoke run needs no
    image library."""
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], 1)

    def chunk(kind, data):
        body = kind + data
        return struct.pack(">I", len(data)) + body + struct.pack(
            ">I", zlib.crc32(body) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)))
        f.write(chunk(b"IEND", b""))


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

    from sports_field_homography_tpu_torch.data.assets import open_court_template
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
    results["warp_nearest"] = (k1_err, *k1_ms)

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
            if c == 64 and prologue is not None:
                k2_ms = (ms_b, pms_b)
            del got, ref, xb, wb
        del x32
    results["conv3x3"] = (k2_err, *k2_ms)

    # --- K3: deconv k2s2 --------------------------------------------------
    k3_err, k3_ms, k3_pms = 0.0, 0.0, 0.0
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
        log(f"K3 deconv2x2 {tag}: max abs err f32 {err:.2e}, bf16 vs f32 {errb:.2e}; "
            f"bf16 kernel {ms:.3f} ms, plain (cuDNN) {pms:.3f} ms [{card}]")
        k3_err = max(k3_err, err, errb)
        k3_ms += ms
        k3_pms += pms
    log(f"K3 deconv2x2 all four up-convs, bf16: kernel {k3_ms:.3f} ms, plain {k3_pms:.3f} ms")
    results["deconv2x2"] = (k3_err, k3_ms, k3_pms)
    return results


def phase_slice(dev, card, work):
    import torch

    from sports_field_homography_tpu_torch.cli import predict as predict_cli
    from sports_field_homography_tpu_torch.cli.engine import build_model
    from sports_field_homography_tpu_torch.data.dataset import BasicDataset
    from sports_field_homography_tpu_torch.models import Reconstructor, ReconstructorConfig
    from sports_field_homography_tpu_torch.models.layers import init_weights
    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3
    from sports_field_homography_tpu_torch.ops.deconv import deconv2x2
    from sports_field_homography_tpu_torch.ops.warp import warp_nearest

    frames = os.path.join(work, "game0")
    os.makedirs(frames)
    rng = np.random.default_rng(0)
    for i in range(16):
        write_png(os.path.join(frames, f"{i:06d}.png"),
                  rng.integers(0, 256, size=(360, 640, 3), dtype=np.uint8))
    model = Reconstructor(ReconstructorConfig(resnet_name="resnet34",
                                              resnet_input="img+mask"))
    gen = torch.Generator().manual_seed(0)
    init_weights(model, gen)
    with torch.no_grad():      # fresh init regresses identity: vary theta
        model.resnet_reg.reg.weight.copy_(
            torch.randn(model.resnet_reg.reg.weight.shape, generator=gen) * 5e-3)
    ckpt = os.path.join(work, "flagship", "model.pth")
    os.makedirs(os.path.dirname(ckpt))
    torch.save(model.state_dict(), ckpt)
    dst = os.path.join(work, "out")

    kernels = {"warp_nearest": warp_nearest, "conv3x3": conv3x3, "deconv2x2": deconv2x2}
    for fn in kernels.values():
        fn.launches = 0
    stats = predict_cli.process(
        ["--img_dir", frames, "--load", ckpt, "--dst_dir", dst,
         "--req_outputs", "theta,consistency", "--batchsize", str(BATCH),
         "--court_img", COURT_IMG, "--court_poi", COURT_POI])
    launches = {name: fn.launches for name, fn in kernels.items()}
    log(f"slice: kernel launches in the CLI run: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"slice: {name} was never launched by the main path")
    with open(os.path.join(dst, "game0_court.json")) as f:
        out = json.load(f)
    if out.pop("model") != "flagship":
        raise AssertionError("slice: wrong model name in the JSON")
    if len(out) != 16:
        raise AssertionError(f"slice: {len(out)} records, expected 16")
    thetas = np.array([rec["theta"] for rec in out.values()], np.float64)
    scores = np.array([rec["score"] for rec in out.values()], np.float64)
    if thetas.shape != (16, 1, 3, 3) or not np.isfinite(thetas).all() \
            or not np.isfinite(scores).all():
        raise AssertionError("slice: non-finite or misshapen records")
    log(f"slice: 16 finite records; theta spread {thetas.std(0).max():.3e}, "
        f"scores {scores.min():.4f}..{scores.max():.4f}; CLI loop "
        f"{stats['frames'] / stats['seconds']:.1f} frames/s (host pipeline "
        f"included, 2 batches) [{card}]")

    # f32 parity: CUDA (TF32 off) against the CPU's plain versions
    class Args:
        target_size = unet_size = (640, 360)
        warp_size = court_size = (1280, 720)
        mask_classes = 4
        use_unet = use_resnet = use_warper = True
        unet_bilinear = unet_uv = False
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
    log(f"slice f32 CUDA vs CPU: theta max abs {d_theta:.3e} (bound 2e-4), "
        f"score max abs {d_score:.3e} (bound 1e-3)")
    if not (d_theta <= 2e-4 and d_score <= 1e-3):
        raise AssertionError("slice: f32 CUDA and CPU disagree beyond the bounds")

    # steady-state device throughput of the predict path at batch 8 (bf16)
    Args.device, Args.compute_dtype = "cuda", "bfloat16"
    b = build_model(Args, load=ckpt, fold_bn=True)
    xb = torch.from_numpy(np.stack([ds[i % 2]["image"] for i in range(BATCH)])).to(dev)

    def step():
        with torch.inference_mode():
            b.model.predict(xb.float() / 255.0, b.court_labels, b.value_step)

    ms = cuda_ms(step, warmup=2, runs=5)
    log(f"slice: predict theta+consistency 640x360 bf16 batch {BATCH}: {ms:.2f} ms/batch, "
        f"{BATCH * 1000.0 / ms:.1f} frames/s (CUDA events, median of 5) [{card}]")
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, PKG)):
        print(f"chip_smoke: {PKG}/ not found beside this script; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch

    card = phase_device()
    dev = torch.device("cuda:0")
    phase_build()
    kres = phase_kernels(dev, card)
    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    launches = phase_slice(dev, card, work)

    src = f"{PKG}/csrc"
    table = [
        ("warp_nearest", "warp_nearest.cu", "sports_field_homography_tpu/ops/warp_pallas.py:96"),
        ("conv3x3", "conv3x3.cu", "sports_field_homography_tpu/ops/conv3x3_pallas.py:151"),
        ("deconv2x2", "deconv2x2.cu", "sports_field_homography_tpu/ops/deconv_pallas.py:186"),
    ]
    kernels = []
    for name, fname, replaces in table:
        err, ms, pms = kres[name]
        kernels.append({"name": name, "route": "cuda", "source": f"{src}/{fname}",
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": pms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
