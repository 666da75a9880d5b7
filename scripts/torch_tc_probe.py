#!/usr/bin/env python3
"""Quick check and tuning probe of the redesigned kernels on one NVIDIA
GPU: the tensor-core K2, K5, K3 and K3-bwd (``csrc/conv3x3_sm90.cu``,
``csrc/wgrad3x3_sm90.cu``, ``csrc/deconv2x2_sm90.cu``), K1
(``csrc/warp_nearest.cu``) and K7-bwd (``csrc/bn_relu_bwd.cu``).

    python3 scripts/torch_tc_probe.py [--kernels k2,k5,k3,k1,k7bwd] [--variants]

Builds the kernels (printing what ptxas reports), then holds the bf16
``conv3x3`` (one and two inputs, prologue, stats), ``wgrad3x3``,
``deconv2x2`` and ``deconv2x2_backward`` against their plain versions at
edge shapes (ragged M, 1x1 images, BN = 64 and 128 tiles) and at the
UNet's shapes (batch 8), checks that every call took the tensor-core route
and that the sums repeat bitwise, and prints each batch-8 shape's time
(CUDA events, median of 5; K3 beside ``F.conv_transpose2d`` and its
autograd).  K1 on the predict, test-CLI and ragged grids and K7-bwd at the
five UNet levels (bf16) and level 1 in f32 are held to their plain
versions the same way (labels equal; dx, bitwise-repeated sums, the
16-byte route), each timed whole and bare (a CUDA graph of back-to-back
calls) beside its library call.  Exits non-zero on a failure.

``--variants`` also compiles variants of the selected kernels from a
scratch copy of ``csrc/`` (K2: the ring 5 or 6 stages deep, ``cp.async.ca``
gathers through L1, two blocks per SM forced by ``__launch_bounds__``; K5:
rings of 6 and 8; K3: a 4-stage ring, one block per SM allowed, K3-bwd's
wgrad ring 3 or 6 deep; K1: 2, 4 or 8 columns a thread; K7-bwd: pass 2 in
pass 1's row order, an 8-lane final sum, 2 or 4 rows in flight a thread,
and 2 to 16 blocks per SM) and times the bare kernels at the UNet's shapes
beside the committed version, each held to the plain result.
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
    ("dc_base", "deconv2x2_sm90.cu", []),
    ("dc_s4", "deconv2x2_sm90.cu", [("constexpr int kStages = 3;", "constexpr int kStages = 4;")]),
    ("dc_lb1", "deconv2x2_sm90.cu", [("__launch_bounds__(kThreads, 2)",
                                      "__launch_bounds__(kThreads, 1)")]),
    ("dc_s4lb1", "deconv2x2_sm90.cu", [("constexpr int kStages = 3;", "constexpr int kStages = 4;"),
                                        ("__launch_bounds__(kThreads, 2)",
                                         "__launch_bounds__(kThreads, 1)")]),
    ("dc_wg3", "deconv2x2_sm90.cu", [("constexpr int kWgStages = 4;",
                                      "constexpr int kWgStages = 3;")]),
    ("dc_wg6", "deconv2x2_sm90.cu", [("constexpr int kWgStages = 4;",
                                      "constexpr int kWgStages = 6;")]),
    ("k1_v2", "warp_nearest.cu", [("constexpr int kCols = 4;", "constexpr int kCols = 2;")]),
    ("k1_v4", "warp_nearest.cu", []),
    ("k1_v8", "warp_nearest.cu", [("constexpr int kCols = 4;", "constexpr int kCols = 8;")]),
    ("k7_base", "bn_relu_bwd.cu", []),
    ("k7_inorder", "bn_relu_bwd.cu", [("constexpr bool kDxReverse = true;",
                                       "constexpr bool kDxReverse = false;")]),
    ("k7_fin8", "bn_relu_bwd.cu", [("constexpr int kFinishLanes = 32;",
                                    "constexpr int kFinishLanes = 8;")]),
    ("k7_u2", "bn_relu_bwd.cu", [("constexpr int kUnroll = 8;", "constexpr int kUnroll = 2;")]),
    ("k7_u4", "bn_relu_bwd.cu", [("constexpr int kUnroll = 8;", "constexpr int kUnroll = 4;")]),
]
# variant name prefix -> (the --kernels tag, its C entry points)
_VARIANT_KERNELS = {"conv": ("k2", ["sfh_conv3x3_sm90"]), "wg": ("k5", ["sfh_wgrad3x3_sm90"]),
                    "dc": ("k3", ["sfh_deconv2x2_sm90", "sfh_deconv2x2_bwd_sm90"]),
                    "k1": ("k1", ["sfh_warp_nearest"]), "k7": ("k7bwd", ["sfh_bn_relu_bwd"])}
K7_LEVELS = [(360, 640, 64), (180, 320, 128), (90, 160, 256), (45, 80, 512), (22, 40, 1024)]
COURT_IMG = os.path.join(REPO, "assets", "mask_ncaa_v4_nc4_m_onehot.png")
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
K3_SHAPES = [  # (n, h, w, cin, cout): edges, then the four up-convs
    (1, 5, 7, 64, 64), (2, 45, 80, 128, 64), (1, 1, 1, 64, 128), (1, 3, 5, 1024, 512),
    (2, 7, 9, 64, 192), (8, 22, 40, 1024, 512), (8, 45, 80, 512, 256), (8, 90, 160, 256, 128),
    (8, 180, 320, 128, 64)]


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


def graph_ms(fn, n=20, runs=5):
    """Median device ms of one fn() from a CUDA graph of n back-to-back calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _thetas(gen, dev, b):
    import torch

    scale = torch.tensor([[0.1, 0.1, 0.2], [0.1, 0.1, 0.2], [0.05, 0.05, 0.0]], device=dev)
    return torch.eye(3, device=dev) + torch.randn((b, 3, 3), generator=gen, device=dev) * scale


def check_k1(dev, gen):
    """K1 through its wrapper on the predict grid (1280x720 sampled at
    360x640), the test CLI's (640x360 full) and a ragged one; returns the
    failures."""
    import torch
    import torch.nn.functional as F

    from sports_field_homography_tpu_torch.data.assets import open_court_template
    from sports_field_homography_tpu_torch.geometry.warp import subsampled_warp_grid
    from sports_field_homography_tpu_torch.ops.warp import (template_value_table, warp_nearest,
                                                            warp_nearest_plain)

    fails = 0
    for size, out_hw, sample_hw in (((1280, 720), (720, 1280), (360, 640)),
                                    ((640, 360), (360, 640), None),
                                    ((1280, 720), (359, 641), None)):
        labels_np = open_court_template(COURT_IMG, 4, size=size)
        labels, values = torch.from_numpy(labels_np).to(dev), template_value_table(labels_np, 4).to(dev)
        theta = _thetas(gen, dev, 8)

        def run():
            return warp_nearest(labels, theta, out_hw, values, sample_hw)

        n0, v0 = warp_nearest.launches, warp_nearest.vec_launches
        got = run()
        vec = warp_nearest.vec_launches - v0 == warp_nearest.launches - n0 == 1
        ok = torch.equal(got, warp_nearest_plain(labels, theta, out_hw, values, sample_hw))
        ok = ok and vec == ((sample_hw or out_hw)[1] % 4 == 0)
        grid = subsampled_warp_grid(theta, out_hw, sample_hw) if sample_hw else None
        t = ""
        if grid is not None:
            tmpl = labels.float().expand(8, 1, *labels.shape).contiguous()

            def lib():
                return F.grid_sample(tmpl, grid, mode="nearest", align_corners=False)

            t = (f"; F.grid_sample {cuda_ms(lib, 9):.4f} ms whole, {graph_ms(lib):.4f} bare")
        print(f"K1 {size[0]}x{size[1]} -> {out_hw} sample_hw={sample_hw}: "
              f"{'ok' if ok else 'FAIL'} (float4 stores: {vec}); {cuda_ms(run, 9):.4f} ms "
              f"whole, {graph_ms(run):.4f} bare{t}", flush=True)
        fails += not ok
    return fails


def _bn_case(gen, dev, n, h, w, c, dtype):
    import torch

    y = (torch.randn((n, h, w, c), generator=gen, device=dev) * 2.0 + 0.3).to(dtype)
    g = torch.randn((n, h, w, c), generator=gen, device=dev).to(dtype)
    yf = y.float()
    mean = yf.mean(dim=(0, 1, 2))
    vecs = (mean, torch.rsqrt((yf * yf).mean(dim=(0, 1, 2)) - mean * mean + 1e-5),
            torch.rand((c,), generator=gen, device=dev) + 0.5,
            torch.randn((c,), generator=gen, device=dev) * 0.3)
    return y, g, vecs


def check_k7bwd(dev, gen):
    """K7-bwd through its wrapper at the five UNet levels (bf16, batch 8)
    and level 1 in f32; returns the failures."""
    import torch
    import torch.nn.functional as F

    from sports_field_homography_tpu_torch.ops.bn_relu_bwd import bn_relu_bwd, bn_relu_bwd_plain

    fails = 0
    for (h, w, c), dtype in [(lvl, torch.bfloat16) for lvl in K7_LEVELS] + [
            (K7_LEVELS[0], torch.float32)]:
        y, g, vecs = _bn_case(gen, dev, 8, h, w, c, dtype)

        def run():
            return bn_relu_bwd(y, g, *vecs)

        n0, v0 = bn_relu_bwd.launches, bn_relu_bwd.vec_launches
        (dx, dgam, dbet), again = run(), run()
        vec = bn_relu_bwd.vec_launches - v0 == bn_relu_bwd.launches - n0 == 2
        dx_ref, dgam_ref, dbet_ref = bn_relu_bwd_plain(y, g, *vecs)
        tol, red = (1e-4, 1e-5) if dtype == torch.float32 else (2e-2, 1e-3)
        if dtype == torch.float32:
            _, dgam_ref, dbet_ref = bn_relu_bwd_plain(y.double(), g.double(),
                                                      *(v.double() for v in vecs))
        errs = ((dx.float() - dx_ref.float()).abs().max().item(), rel_l2(dgam, dgam_ref),
                rel_l2(dbet, dbet_ref))
        ok = (vec and torch.allclose(dx.float(), dx_ref.float(), rtol=tol, atol=tol)
              and max(errs[1:]) <= red and all(torch.equal(a, b) for a, b in zip((dx, dgam, dbet),
                                                                                  again)))
        yl = y.permute(0, 3, 1, 2).detach().requires_grad_()
        gl, bl = vecs[2].clone().requires_grad_(), vecs[3].clone().requires_grad_()
        out = torch.relu(F.batch_norm(yl, None, None, gl, bl, training=True, eps=1e-5))
        gn = g.permute(0, 3, 1, 2)
        lib = cuda_ms(lambda: torch.autograd.grad(out, (yl, gl, bl), gn, retain_graph=True), 9)
        print(f"K7-bwd {h}x{w}x{c} {str(dtype)[6:]}: {'ok' if ok else 'FAIL'} (16-byte route: "
              f"{vec}; dx {errs[0]:.2e}, sums rel-L2 {max(errs[1:]):.2e}); {cuda_ms(run, 9):.3f} "
              f"ms whole, {graph_ms(run, 10):.3f} bare; library {lib:.3f} ms whole", flush=True)
        fails += not ok
        del y, g, dx, dx_ref, again, yl, out, gn
    return fails


def check_deconv(dev, gen):
    """K3 and K3-bwd through their wrappers; returns the failures."""
    import torch
    import torch.nn.functional as F

    from sports_field_homography_tpu_torch.ops.deconv import (
        deconv2x2, deconv2x2_backward, deconv2x2_backward_plain, deconv2x2_plain)

    fails = 0
    for n, h, w, cin, cout in K3_SHAPES:
        x = torch.randn((n, h, w, cin), generator=gen, device=dev).bfloat16()
        wt = (torch.randn((cin, 2, 2, cout), generator=gen, device=dev) * cin ** -0.5).bfloat16()
        b = torch.randn(cout, generator=gen, device=dev) * 0.1
        dy = torch.randn((n, 2 * h, 2 * w, cout), generator=gen, device=dev).bfloat16()
        f0, b0 = deconv2x2.tc_launches, deconv2x2_backward.tc_launches
        y = deconv2x2(x, wt, b)
        (dx, dw, db), (_, dw2, _) = deconv2x2_backward(x, dy, wt), deconv2x2_backward(x, dy, wt)
        y_ref = deconv2x2_plain(x.float(), wt.float(), b)
        dx_ref, dw_ref, db_ref = deconv2x2_backward_plain(x, dy, wt)
        errs = ((y.float() - y_ref).abs().max().item(), (dx.float() - dx_ref.float()).abs().max().item(),
                rel_l2(dw, dw_ref), rel_l2(db, db_ref))
        ok = (deconv2x2.tc_launches - f0 == 1 and deconv2x2_backward.tc_launches - b0 == 2
              and torch.allclose(y.float(), y_ref, rtol=2e-2, atol=2e-2)
              and torch.allclose(dx.float(), dx_ref.float(), rtol=2e-2, atol=2e-2)
              and max(errs[2:]) <= 1e-3 and torch.equal(dw, dw2))
        t = ""
        if n == 8:
            xl = x.permute(0, 3, 1, 2).detach().requires_grad_()
            wl = wt.permute(0, 3, 1, 2).contiguous().requires_grad_()
            bl = b.bfloat16().requires_grad_()
            out = F.conv_transpose2d(xl, wl, bl, stride=2)
            dyn = dy.permute(0, 3, 1, 2)
            t = (f", fwd {cuda_ms(lambda: deconv2x2(x, wt, b)):.3f} ms (library "
                 f"{cuda_ms(lambda: F.conv_transpose2d(xl, wl, bl, stride=2)):.3f}), bwd "
                 f"{cuda_ms(lambda: deconv2x2_backward(x, dy, wt)):.3f} ms (library "
                 f"{cuda_ms(lambda: torch.autograd.grad(out, (xl, wl, bl), dyn, retain_graph=True)):.3f})")
        print(f"K3 {n}x{h}x{w} {cin}->{cout}: {'ok' if ok else 'FAIL'} (y {errs[0]:.2e}, dx "
              f"{errs[1]:.2e}, dW {errs[2]:.2e}, db {errs[3]:.2e}){t}", flush=True)
        fails += not ok
    return fails


def check(dev, gen):
    """The committed K2 and K5 through their wrappers; returns the failures."""
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


def variants(dev, gen, kernels):
    """Compile the variants of the selected kernels and time the bare
    kernels; returns the failures."""
    import torch

    from sports_field_homography_tpu_torch.ops import deconv
    from sports_field_homography_tpu_torch.ops.build import _SIGNATURES, NVCC_FLAGS, _nvcc
    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3_plain, pack_weights
    from sports_field_homography_tpu_torch.ops.reduce import split_reduction

    work = tempfile.mkdtemp(prefix="sfh_variants_")
    procs = {}
    for name, src, edits in VARIANTS:
        if _VARIANT_KERNELS[name.split("_")[0]][0] not in kernels:
            continue
        d = os.path.join(work, name)
        os.makedirs(d)
        for f in [src] + [h for h in os.listdir(CSRC) if h.endswith(".cuh")]:
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
    fns = {}      # name -> its C entry points
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{log[-2000:]}")
        lib = ctypes.CDLL(os.path.join(work, name, "lib.so"))
        fns[name] = []
        for entry in _VARIANT_KERNELS[name.split("_")[0]][1]:
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = _SIGNATURES[entry], ctypes.c_int
            fns[name].append(fn)
    shutil.rmtree(work, ignore_errors=True)

    def rnd(*s, scale=1.0):
        return (torch.randn(s, generator=gen, device=dev) * scale).bfloat16()

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream().cuda_stream
    fails = 0
    for n, h, w, cin, cin2, cout, pro_on, _ in K2_SHAPES:
        if n != 8 or not any(name.startswith("conv") for name in fns):
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
        for name, (fn, *_) in fns.items():
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
        if n != 8 or pro_on or not any(name.startswith("wg") for name in fns):
            continue
        x, dy = rnd(n, h, w, cin), rnd(n, h, w, cout)
        chunk, splits = split_reduction(n * h * w, 9 * cin, cout, stage=64,
                                        tile_cols=128 if cout % 128 == 0 else 64)
        ref = torch.nn.grad.conv2d_weight(x.float().permute(0, 3, 1, 2), (cout, cin, 3, 3),
                                          dy.float().permute(0, 3, 1, 2), padding=1)
        ref = ref.permute(2, 3, 1, 0).reshape(-1)
        part = torch.empty((splits, 9 * cin * cout), dtype=torch.float32, device=dev)
        cells = []
        for name, (fn, *_) in fns.items():
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
    for n, h, w, cin, cout in K3_SHAPES:
        if n != 8 or not any(name.startswith("dc") for name in fns):
            continue
        x, dy = rnd(n, h, w, cin), rnd(n, 2 * h, 2 * w, cout)
        wt = rnd(cin, 2, 2, cout, scale=cin ** -0.5)
        b = torch.randn(cout, generator=gen, device=dev) * 0.1
        wk, wkt = deconv.pack_weights(wt), deconv.pack_weights_t(wt)
        y_ref = deconv.deconv2x2_plain(x.float(), wt.float(), b)
        dx_ref, dw_ref, _ = deconv.deconv2x2_backward_plain(x, dy, wt)
        chunk, splits = deconv.tc_wgrad_split(n * h * w, cin, cout)
        y, dx = torch.empty_like(y_ref, dtype=torch.bfloat16), torch.empty_like(x)
        part = torch.empty((splits, cin * 4 * cout), dtype=torch.float32, device=dev)
        cells = []
        for name, fs in fns.items():
            if not name.startswith("dc"):
                continue

            def fwd(fn=fs[0]):
                return fn(x.data_ptr(), wkt.data_ptr(), b.data_ptr(), y.data_ptr(), n, h, w, cin,
                          cout, stream)

            def bwd(fn=fs[1]):
                return fn(x.data_ptr(), dy.data_ptr(), wk.data_ptr(), dx.data_ptr(), part.data_ptr(),
                          n, h, w, cin, cout, chunk, splits, stream)

            ok = fwd() == 0 and bwd() == 0
            torch.cuda.synchronize()
            ok = (ok and torch.allclose(y.float(), y_ref, rtol=2e-2, atol=2e-2)
                  and torch.allclose(dx.float(), dx_ref.float(), rtol=2e-2, atol=2e-2)
                  and rel_l2(part.sum(0), dw_ref.reshape(-1)) <= 1e-3)
            cells.append(f"{name} {cuda_ms(fwd, 9):.3f} / {cuda_ms(bwd, 9):.3f}"
                         f"{'' if ok else ' FAIL'}")
            fails += not ok
        print(f"variants K3 / K3-bwd (dgrad + wgrad, before the column sums) {cin}->{cout} at "
              f"{h}x{w} (ms): " + ", ".join(cells), flush=True)
    return fails + k1_k7_variants(dev, gen, fns)


def k1_k7_variants(dev, gen, fns):
    """The bare K1 and K7-bwd variants (CUDA graph of back-to-back calls on
    the current stream), each held to the plain version; returns the
    failures."""
    import torch

    from sports_field_homography_tpu_torch.data.assets import open_court_template
    from sports_field_homography_tpu_torch.ops import bn_relu_bwd as k7
    from sports_field_homography_tpu_torch.ops.warp import (grid_constants, template_value_table,
                                                            warp_nearest_plain)

    fails = 0
    if any(name.startswith("k1") for name in fns):
        labels_np = open_court_template(COURT_IMG, 4, size=(1280, 720))
        labels, values = torch.from_numpy(labels_np).to(dev), template_value_table(labels_np, 4).to(dev)
        theta = _thetas(gen, dev, 8)
        for out_hw, sample_hw in (((720, 1280), (360, 640)), ((720, 1280), None)):
            ho, wo = sample_hw or out_hw
            ref = warp_nearest_plain(labels, theta, out_hw, values, sample_hw)
            out = torch.empty_like(ref)
            consts = grid_constants(out_hw, sample_hw)
            cells = []
            for name, (fn,) in fns.items():
                if not name.startswith("k1"):
                    continue

                def call(fn=fn):
                    return fn(labels.data_ptr(), 720, 1280, theta.data_ptr(), 8, ho, wo, *out_hw,
                              int(sample_hw is not None), *consts, values.data_ptr(),
                              out.data_ptr(), 1, torch.cuda.current_stream().cuda_stream)

                ok = call() == 0
                torch.cuda.synchronize()
                ok = ok and torch.equal(out, ref)
                cells.append(f"{name} {graph_ms(call):.4f}{'' if ok else ' FAIL'}")
                fails += not ok
            print(f"variants K1 {out_hw} sample_hw={sample_hw}, bare (ms): " + ", ".join(cells),
                  flush=True)
    if not any(name.startswith("k7") for name in fns):
        return fails
    for h, w, c in K7_LEVELS[:1] + K7_LEVELS[3:4]:
        y, g, vecs = _bn_case(gen, dev, 8, h, w, c, torch.bfloat16)
        m = 8 * h * w
        dx_ref, dgam_ref, _ = k7.bn_relu_bwd_plain(y, g, *vecs)
        dx = torch.empty_like(y)
        lanes = k7.row_lanes(c, 8)
        cells = []
        for name, (fn,) in fns.items():
            if not name.startswith("k7"):
                continue
            for per_sm in ((2, 4, 8, 16) if name == "k7_base" else (4,)):
                chunk, blocks = k7.row_schedule(m, lanes, 132 * per_sm)
                part = torch.empty((blocks, 2 * c), dtype=torch.float32, device=dev)
                sums = torch.empty(2 * c, dtype=torch.float32, device=dev)

                def call(fn=fn, chunk=chunk, part=part, sums=sums):
                    return fn(y.data_ptr(), g.data_ptr(), *(v.data_ptr() for v in vecs),
                              part.data_ptr(), sums.data_ptr(), dx.data_ptr(), m, c, chunk, 1, 1,
                              torch.cuda.current_stream().cuda_stream)

                ok = call() == 0
                torch.cuda.synchronize()
                ok = (ok and torch.allclose(dx.float(), dx_ref.float(), rtol=2e-2, atol=2e-2)
                      and rel_l2(sums[c:], dgam_ref) <= 1e-3)
                cells.append(f"{name} {per_sm}/SM {graph_ms(call, 10):.3f}{'' if ok else ' FAIL'}")
                fails += not ok
        print(f"variants K7-bwd bf16 {h}x{w}x{c}, bare (ms): " + ", ".join(cells), flush=True)
        del y, g, dx, dx_ref
    return fails


def host_profile(dev, gen, kernels, calls=500):
    """Host microseconds per call of the K1 and K7-bwd wrappers at a small
    shape (the device keeps up, so the host's own time shows), and
    cProfile's heaviest entries over the same calls."""
    import cProfile
    import pstats
    import time

    import torch

    from sports_field_homography_tpu_torch.ops.bn_relu_bwd import bn_relu_bwd
    from sports_field_homography_tpu_torch.ops.warp import warp_nearest

    cases = []
    if "k1" in kernels:
        labels = torch.randint(0, 4, (720, 1280), generator=gen, device=dev, dtype=torch.uint8)
        theta, values = _thetas(gen, dev, 8), torch.arange(256, dtype=torch.float32, device=dev)
        cases.append(("K1 sampled 360x640 of 1280x720",
                      lambda: warp_nearest(labels, theta, (720, 1280), values, (360, 640))))
    if "k7bwd" in kernels:
        y, g, vecs = _bn_case(gen, dev, 8, 22, 40, 1024, torch.bfloat16)
        cases.append(("K7-bwd 22x40x1024 bf16", lambda: bn_relu_bwd(y, g, *vecs)))
    for tag, fn in cases:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(calls):
            fn()
        prof.disable()
        torch.cuda.synchronize()
        print(f"host {tag}: {host:.1f} us a call (perf_counter over {calls} calls); cProfile, "
              f"heaviest by own time:", flush=True)
        pstats.Stats(prof).sort_stats("tottime").print_stats(14)
    if "k7bwd" not in kernels:
        return
    # the C entry point alone through ctypes: m = 0 returns before any
    # launch (ctypes' own cost), the real call makes K7-bwd's three launches
    from sports_field_homography_tpu_torch.ops import bn_relu_bwd as k7
    from sports_field_homography_tpu_torch.ops.build import load_library

    m, c = 8 * 22 * 40, 1024
    chunk, blocks = k7.row_schedule(m, k7.row_lanes(c, 8))
    part = torch.empty((blocks, 2 * c), dtype=torch.float32, device=dev)
    sums, dx = torch.empty(2 * c, dtype=torch.float32, device=dev), torch.empty_like(y)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (y, g, *vecs, part, sums, dx)]
    fn = load_library().sfh_bn_relu_bwd
    for rows, what in ((0, "no launch"), (m, "3 launches")):
        for _ in range(20):
            fn(*ptrs, rows, c, chunk, 1, 1, stream)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*ptrs, rows, c, chunk, 1, 1, stream)
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        print(f"host ctypes sfh_bn_relu_bwd, {what}: {us:.1f} us a call", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default="k2,k5,k3")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--host", action="store_true",
                    help="profile the K1 and K7-bwd wrappers' host time per call")
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    sys.path.insert(0, REPO)
    import torch

    from sports_field_homography_tpu_torch.ops import build

    if not torch.cuda.is_available():
        raise SystemExit("torch_tc_probe: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    build.load_library()
    for f in sorted(build.build_dir().glob("*.log")):
        for line in f.read_text().splitlines():
            if ("registers" in line or "spill" in line or "Compiling entry" in line
                    or "error" in line.lower()):
                print("ptxas: " + line.strip())
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    fails = check(dev, gen) if kernels & {"k2", "k5"} else 0
    if "k3" in kernels:
        fails += check_deconv(dev, gen)
    if "k1" in kernels:
        fails += check_k1(dev, gen)
    if "k7bwd" in kernels:
        fails += check_k7bwd(dev, gen)
    if args.variants:
        fails += variants(dev, gen, kernels)
    if args.host:
        host_profile(dev, gen, kernels)
    print(f"failures: {fails} [{card}]")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
