#!/usr/bin/env python3
"""Time, and optionally profile, flagship train steps (or predict
batches) of the PyTorch port (``sports_field_homography_tpu_torch``) on one
NVIDIA GPU.

    python3 scripts/torch_train_profile.py [--batch 8] [--profile] [--unet_bilinear]
        [--predict [--full_outputs]]

The flagship (UNet deconv 64..1024, or with ``--unet_bilinear`` the
bilinear UNet, + ResNet34 on img+mask, 4 classes, 640x360, bf16) with
seeded random weights takes train steps on a fixed batch of synthetic
court renders (``chip_smoke.flagship_train_step``), or with ``--predict``
runs the predict CLI's device path, BN folded, theta + consistency (with
``--full_outputs`` also poi and the segm and warp masks, K1 on the full
1280x720 grid), the outputs copied to pinned host memory, on a batch of
seeded frames (``chip_smoke.flagship_predict_step``).
Prints the card's name and power limit, then ms/step and img/s (CUDA
events, median of 5 steps after 2 warm-up).  With ``--profile`` one more
step runs under ``torch.profiler``: device time by kernel (top 25), the
share of each kernel group, and the device's busy share of the step.
"""
import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# kernel-name patterns (lower case) -> group, first match wins; every
# group of the port's kernels comes before cuDNN's, whose keys ("conv",
# "gemm", "wgrad", "dgrad") the port's names contain too
_GROUPS = [
    ("K1 warp_nearest", ("warp_nearest",)),
    ("K2 conv3x3 tensor cores (fwd, stats, dgrad)", ("conv3x3_sm90_kernel",)),
    ("K5 wgrad3x3 tensor cores", ("wgrad3x3_sm90_kernel",)),
    # the forward and the dgrad are one kernel template, told apart by its map
    ("K3 deconv2x2 fwd tensor cores", ("fwdmap",)),
    ("K3-bwd deconv2x2 dgrad + wgrad tensor cores", ("dgradmap", "deconv2x2_sm90_wgrad")),
    ("K2 conv3x3 SIMT", ("conv3x3_kernel",)),
    ("K5 wgrad3x3 SIMT", ("wgrad3x3_kernel",)),
    ("K7-bwd bn_relu_bwd", ("bn_relu_bwd",)),
    ("K7-fwd bn_relu stats + norm", ("bn_relu_stats", "bn_relu_norm")),
    ("K3 deconv2x2 fwd SIMT", ("deconv2x2_kernel",)),
    ("K3-bwd deconv2x2 dgrad + wgrad SIMT", ("deconv2x2_dgrad", "deconv2x2_wgrad")),
    ("column sums (sum_rows)", ("sum_rows_kernel",)),
    # before cuDNN's group: their kernel names contain "nhwc"
    ("max-pool", ("max_pool",)),
    ("bilinear up-sampling", ("upsample",)),
    ("cuDNN / cuBLAS (stem, ResNet, 1x1 heads)", ("cudnn", "xmma", "gemm", "conv",
                                                  "cutlass", "nchw", "nhwc", "wgrad", "dgrad")),
    ("optimizer (RMSprop) and clamps", ("multi_tensor", "foreach", "clamp")),
    ("reductions (argmax, logsumexp, means)", ("reduce", "argmax")),
    ("gather / scatter / index", ("index", "gather", "scatter")),
    ("copies to the host (D2H)", ("DtoH",)),
    ("concat / copy / pad", ("cat", "copy", "pad", "Memcpy", "Memset")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "Activation")),
]


def _group(name):
    low = name.lower()
    for group, keys in _GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--unet_bilinear", action="store_true")
    ap.add_argument("--predict", action="store_true")
    ap.add_argument("--full_outputs", action="store_true",
                    help="with --predict: BASELINE config #2's outputs")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import subprocess

    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("torch_train_profile: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda:0")
    if args.predict:
        step = chip_smoke.flagship_predict_step(dev, args.batch, args.unet_bilinear,
                                                args.full_outputs)
    else:
        step = chip_smoke.flagship_train_step(dev, args.batch, args.unet_bilinear)
    ms = chip_smoke.cuda_ms(step, warmup=2, runs=5)
    variant = ("bilinear" if args.unet_bilinear else "flagship") + (
        (" predict, full outputs" if args.full_outputs else " predict") if args.predict
        else " train")
    print(f"{variant} 640x360 bf16 batch {args.batch}: {ms:.1f} ms/step, "
          f"{args.batch * 1000.0 / ms:.1f} img/s (CUDA events, median of 5) "
          f"[{card}]; peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB",
          flush=True)
    if not args.profile:
        return 0
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
    step_ms = start.elapsed_time(end)
    kernels = {}
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0.0)
        # "#" marks a user annotation (``Optimizer.step#RMSprop.step``) whose
        # device time spans the kernels under it: not a kernel of its own
        if t and str(getattr(evt, "device_type", "")).endswith("CUDA") and "#" not in evt.key:
            kernels[evt.key] = (kernels.get(evt.key, (0.0, 0))[0] + t / 1000.0,
                                kernels.get(evt.key, (0.0, 0))[1] + evt.count)
    busy = sum(t for t, _ in kernels.values())
    if busy == 0:
        print("profile: no device time in the trace (torch.profiler saw no kernels)")
        return 1
    print(f"profiled step: {step_ms:.1f} ms (CUDA events); kernel time {busy:.1f} ms; "
          f"device busy {100 * busy / step_ms:.1f} %, idle {100 - 100 * busy / step_ms:.1f} %")
    groups = {}
    for name, (t, n) in kernels.items():
        g = groups.setdefault(_group(name), [0.0, 0])
        g[0] += t
        g[1] += n
    print("share by group (kernel time, launches):")
    for g, (t, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {100 * t / busy:5.1f} %  {t:8.2f} ms  {n:5d}  {g}")
    print("top 25 kernels:")
    for name, (t, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"  {100 * t / busy:5.1f} %  {t:8.2f} ms  {n:5d}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
