#!/usr/bin/env python3
"""Quick check and tuning probe of the tensor-core K2 and K5 on one NVIDIA
GPU (``csrc/conv3x3_sm90.cu``, ``csrc/wgrad3x3_sm90.cu``).

    python3 scripts/torch_tc_probe.py [--variants]

Builds the kernels, then holds the bf16 ``conv3x3`` (one and two inputs,
prologue, stats) and ``wgrad3x3`` against their plain versions at edge
shapes (ragged M, 1x1 images, BN = 64 and 128 tiles) and at the UNet's
level-1 and deep-level shapes (batch 8), checks that every call took the
tensor-core route and that the sums repeat bitwise, and prints each
level shape's time (CUDA events, median of 5).  Exits non-zero on a
failure.

``--variants`` also compiles variants of the two kernels from a scratch
copy of ``csrc/`` (the ring 5 or 6 stages deep, ``cp.async.ca`` gathers
through L1, two K2 blocks per SM forced by ``__launch_bounds__``; K5
rings of 6 and 8) and times the bare kernels at the level shapes beside
the committed version, each held to the plain result.
"""
import argparse
import ctypes
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "sports_field_homography_tpu_torch", "csrc")

# (name, file, [(text, replacement)]); "@hdr" edits igemm_sm90.cuh
VARIANTS = [
    ("conv_base", "conv3x3_sm90.cu", []),
    ("conv_s5", "conv3x3_sm90.cu", [("constexpr int kStages = 4;", "constexpr int kStages = 5;")]),
    ("conv_s6", "conv3x3_sm90.cu", [("constexpr int kStages = 4;", "constexpr int kStages = 6;")]),
    ("conv_ca", "conv3x3_sm90.cu", [("@hdr", "cp.async.cg.shared", "cp.async.ca.shared")]),
    ("conv_lb2", "conv3x3_sm90.cu", [("__launch_bounds__(kThreads, 1)",
                                      "__launch_bounds__(kThreads, 2)")]),
    ("wg_base", "wgrad3x3_sm90.cu", []),
    ("wg_s6", "wgrad3x3_sm90.cu", [("constexpr int kStages = 4;", "constexpr int kStages = 6;")]),
    ("wg_s8", "wgrad3x3_sm90.cu", [("constexpr int kStages = 4;", "constexpr int kStages = 8;")]),
    ("wg_ca", "wgrad3x3_sm90.cu", [("@hdr", "cp.async.cg.shared", "cp.async.ca.shared")]),
]
K2_SHAPES = [  # (n, h, w, cin, cin2, cout, prologue, stats)
    (1, 5, 7, 64, 0, 64, False, False), (2, 33, 65, 64, 0, 128, True, True),
    (3, 1, 1, 128, 0, 64, True, True), (2, 22, 40, 64, 128, 64, True, True),
    (8, 360, 640, 64, 0, 64, False, False), (8, 360, 640, 64, 0, 64, True, True),
    (8, 180, 320, 128, 0, 128, False, False), (8, 45, 80, 512, 0, 512, False, False),
    (8, 22, 40, 1024, 0, 1024, False, False), (8, 360, 640, 64, 64, 64, False, False),
    (8, 45, 80, 512, 512, 512, False, True)]
K5_SHAPES = [  # (n, h, w, cin, cout, prologue)
    (1, 5, 7, 64, 64, False), (2, 33, 65, 64, 128, True), (3, 1, 1, 128, 64, True),
    (8, 360, 640, 64, 64, False), (8, 360, 640, 64, 64, True), (8, 180, 320, 128, 128, False),
    (8, 45, 80, 512, 512, False), (8, 22, 40, 1024, 1024, False), (8, 45, 80, 1024, 512, False)]


def cuda_ms(fn, runs=5):
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def check(dev, gen):
    """The committed kernels through their wrappers; returns the failures."""
    import torch

    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain
    from sports_field_homography_tpu_torch.ops.wgrad3x3 import wgrad3x3, wgrad3x3_plain

    def rnd(*s, scale=1.0):
        return (torch.randn(s, generator=gen, device=dev) * scale).bfloat16()

    def prologue(c):
        return (torch.randn(c, generator=gen, device=dev) * 0.1,
                torch.rand(c, generator=gen, device=dev) + 0.5,
                torch.randn(c, generator=gen, device=dev) * 0.1)

    fails = 0
    for n, h, w, cin, cin2, cout, pro_on, st in K2_SHAPES:
        scale = 1.0 / (3 * (cin + cin2) ** 0.5)
        x, wt = rnd(n, h, w, cin), rnd(3, 3, cin, cout, scale=scale)
        x2 = rnd(n, h, w, cin2) if cin2 else None
        w2 = rnd(3, 3, cin2, cout, scale=scale) if cin2 else None
        b = torch.randn(cout, generator=gen, device=dev) * 0.1
        pro = prologue(cin) if pro_on else None

        def run():
            return conv3x3(x, wt, b, pro, stats=st, x2=x2, w2=w2)

        tc0 = conv3x3.tc_launches
        out, again = run(), run()
        ref = conv3x3_plain(x, wt, b, pro, stats=st, x2=x2, w2=w2)
        y, yr = (out[0], ref[0]) if st else (out, ref)
        ok = (conv3x3.tc_launches - tc0 == 2
              and torch.allclose(y.float(), yr.float(), rtol=2e-2, atol=2e-2)
              and (not st or (rel_l2(out[1], ref[1]) <= 1e-3 and torch.equal(out[1], again[1]))))
        t = f"{cuda_ms(run):.3f} ms" if n == 8 else "-"
        print(f"K2 {n}x{h}x{w} {cin}+{cin2}->{cout} prologue={pro_on} stats={st}: "
              f"{'ok' if ok else 'FAIL'}, {t}", flush=True)
        fails += not ok
    for n, h, w, cin, cout, pro_on in K5_SHAPES:
        x, dy = rnd(n, h, w, cin), rnd(n, h, w, cout)
        pro = prologue(cin) if pro_on else None
        tc0 = wgrad3x3.tc_launches
        (dw, db), (dw2, _) = wgrad3x3(x, dy, pro), wgrad3x3(x, dy, pro)
        dw_ref, db_ref = wgrad3x3_plain(x, dy, pro)
        ok = (wgrad3x3.tc_launches - tc0 == 2 and torch.equal(dw, dw2)
              and max(rel_l2(dw, dw_ref), rel_l2(db, db_ref)) <= 1e-3)
        t = f"{cuda_ms(lambda: wgrad3x3(x, dy, pro)):.3f} ms" if n == 8 else "-"
        print(f"K5 {n}x{h}x{w} {cin}->{cout} prologue={pro_on}: {'ok' if ok else 'FAIL'}, {t}",
              flush=True)
        fails += not ok
    return fails


def variants(dev, gen):
    """Compile the variants and time the bare kernels; returns the failures."""
    import torch

    from sports_field_homography_tpu_torch.ops.build import NVCC_FLAGS, _nvcc
    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3_plain, pack_weights
    from sports_field_homography_tpu_torch.ops.reduce import split_reduction

    work = tempfile.mkdtemp(prefix="sfh_variants_")
    procs = {}
    for name, src, edits in VARIANTS:
        d = os.path.join(work, name)
        os.makedirs(d)
        for f in (src, "igemm_sm90.cuh"):
            shutil.copy(os.path.join(CSRC, f), d)
        for edit in edits:
            path, old, new = ((os.path.join(d, "igemm_sm90.cuh"),) + edit[1:]
                              if edit[0] == "@hdr" else (os.path.join(d, src),) + edit)
            text = open(path).read()
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in {os.path.basename(path)}")
            open(path, "w").write(text.replace(old, new))
        flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        procs[name] = subprocess.Popen(
            [_nvcc()] + flags + ["-shared", "-o", os.path.join(d, "lib.so"), os.path.join(d, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{log[-2000:]}")
        lib = ctypes.CDLL(os.path.join(work, name, "lib.so"))
        fn = lib.sfh_conv3x3_sm90 if name.startswith("conv") else lib.sfh_wgrad3x3_sm90
        fn.argtypes = [P] * 10 + [I] * 6 + [P] if name.startswith("conv") else [P] * 3 + [I] * 7 + [P]
        fn.restype = I
        fns[name] = fn
    shutil.rmtree(work, ignore_errors=True)

    def rnd(*s, scale=1.0):
        return (torch.randn(s, generator=gen, device=dev) * scale).bfloat16()

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream().cuda_stream
    fails = 0
    for n, h, w, cin, cin2, cout, pro_on, _ in K2_SHAPES:
        if n != 8:
            continue
        scale = 1.0 / (3 * (cin + cin2) ** 0.5)
        x, wt = rnd(n, h, w, cin), rnd(3, 3, cin, cout, scale=scale)
        x2 = rnd(n, h, w, cin2) if cin2 else None
        w2 = rnd(3, 3, cin2, cout, scale=scale) if cin2 else None
        wk, wk2 = pack_weights(wt), (pack_weights(w2) if cin2 else None)
        b = torch.randn(cout, generator=gen, device=dev) * 0.1
        pro = ([torch.randn(cin, generator=gen, device=dev) * 0.1,
                torch.rand(cin, generator=gen, device=dev) + 0.5,
                torch.randn(cin, generator=gen, device=dev) * 0.1] if pro_on else [None] * 3)
        ref = conv3x3_plain(x, wt, b, pro if pro_on else None, x2=x2, w2=w2).float()
        y = torch.empty((n, h, w, cout), dtype=torch.bfloat16, device=dev)
        cells = []
        for name, fn in fns.items():
            if not name.startswith("conv"):
                continue

            def call(fn=fn):
                return fn(x.data_ptr(), wk.data_ptr(), ptr(x2), ptr(wk2), b.data_ptr(),
                          ptr(pro[0]), ptr(pro[1]), ptr(pro[2]), y.data_ptr(), None, n, h, w,
                          cin, cin2, cout, stream)

            ok = call() == 0
            torch.cuda.synchronize()
            ok = ok and torch.allclose(y.float(), ref, rtol=2e-2, atol=2e-2)
            cells.append(f"{name} {cuda_ms(call, 9):.3f}{'' if ok else ' FAIL'}")
            fails += not ok
        print(f"variants K2 {cin}+{cin2}->{cout} at {h}x{w} prologue={pro_on} (ms): "
              + ", ".join(cells), flush=True)
    for n, h, w, cin, cout, pro_on in K5_SHAPES:
        if n != 8 or pro_on:
            continue
        x, dy = rnd(n, h, w, cin), rnd(n, h, w, cout)
        chunk, splits = split_reduction(n * h * w, 9 * cin, cout, stage=64,
                                        tile_cols=128 if cout % 128 == 0 else 64)
        ref = torch.nn.grad.conv2d_weight(x.float().permute(0, 3, 1, 2), (cout, cin, 3, 3),
                                          dy.float().permute(0, 3, 1, 2), padding=1)
        ref = ref.permute(2, 3, 1, 0).reshape(-1)
        part = torch.empty((splits, 9 * cin * cout), dtype=torch.float32, device=dev)
        cells = []
        for name, fn in fns.items():
            if not name.startswith("wg"):
                continue

            def call(fn=fn):
                return fn(x.data_ptr(), dy.data_ptr(), part.data_ptr(), n, h, w, cin, cout,
                          chunk, splits, stream)

            ok = call() == 0
            torch.cuda.synchronize()
            ok = ok and rel_l2(part.sum(0), ref) <= 1e-3
            cells.append(f"{name} {cuda_ms(call, 9):.3f}{'' if ok else ' FAIL'}")
            fails += not ok
        print(f"variants K5 {cin}->{cout} at {h}x{w}, {splits} splits (ms): " + ", ".join(cells),
              flush=True)
    return fails


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    from sports_field_homography_tpu_torch.ops import build

    if not torch.cuda.is_available():
        raise SystemExit("torch_tc_probe: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    build.load_library()
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    fails = check(dev, gen)
    if args.variants:
        fails += variants(dev, gen)
    print(f"failures: {fails} [{card}]")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
