"""The CUDA kernels against their plain versions on a GPU, at edge shapes
the main paths do not reach (ragged tiles, shallow or odd channel counts,
1x1 images, odd sizes, degenerate homographies, strided inputs, side
streams), and the bitwise repeatability of the training kernels'
reductions (f32 reductions against the plain version in float64, rel-L2
1e-5; bf16 against the plain version on the same inputs, 1e-3).  K2, K5,
K3 and K3-bwd are checked on both routes: the SIMT kernels (f32, odd
channel counts) and the tensor-core kernels (bf16, channels in multiples
of 64), each call's route read from the launch counters.

Marked ``cuda``: each test skips without a CUDA device.  On a GPU box
(which need not have JAX)::

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""
import numpy as np
import pytest
import torch

from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain
from sports_field_homography_tpu_torch.ops.deconv import deconv2x2, deconv2x2_plain
from sports_field_homography_tpu_torch.ops.warp import warp_nearest, warp_nearest_plain

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, shape, dev, scale=1.0):
    return torch.randn(shape, generator=gen, device=dev) * scale


def _close(got, ref, dtype):
    torch.testing.assert_close(got.float(), ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cin,cout", [
    (1, 7, 9, 3, 5),          # K = 27: a partial reduction stage; Cout < 64
    (2, 33, 65, 48, 96),      # M and Cout not multiples of the 64x64 tile
    (3, 1, 1, 16, 64),        # 1x1 images: every tap but the centre is padding
])
@pytest.mark.parametrize("prologue", [False, True])
def test_conv3x3_edges(dev, dtype, n, h, w, cin, cout, prologue):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _rand(gen, (n, h, w, cin), dev).to(dtype)
    wt = _rand(gen, (3, 3, cin, cout), dev, 1.0 / (3 * cin ** 0.5)).to(dtype)
    b = _rand(gen, (cout,), dev, 0.1) if cin != 3 else None
    pro = ((_rand(gen, (cin,), dev, 0.1), torch.rand(cin, generator=gen, device=dev) + 0.5,
            _rand(gen, (cin,), dev, 0.1)) if prologue else None)
    got = conv3x3(x, wt, b, pro)
    ref = conv3x3_plain(x.float(), wt.float(), b, pro)
    assert got.dtype == dtype and got.shape == (n, h, w, cout)
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cin,cout", [(1, 5, 7, 24, 10), (2, 45, 80, 64, 32),
                                            (1, 1, 1, 8, 3)])
def test_deconv_edges(dev, dtype, n, h, w, cin, cout):
    gen = torch.Generator(device=dev).manual_seed(1)
    x = _rand(gen, (n, h, w, cin), dev).to(dtype)
    wt = _rand(gen, (cin, 2, 2, cout), dev, cin ** -0.5).to(dtype)
    b = _rand(gen, (cout,), dev, 0.1)
    got = deconv2x2(x, wt, b)
    assert got.shape == (n, 2 * h, 2 * w, cout)
    _close(got, deconv2x2_plain(x.float(), wt.float(), b), dtype)


@pytest.mark.parametrize("tmpl_hw,out_hw,sample_hw", [
    ((37, 53), (29, 41), None),
    ((72, 128), (720, 1280), (359, 641)),     # upsampling subgrid ratios
    ((720, 1280), (720, 1280), (360, 640)),
])
def test_warp_labels_equal(dev, tmpl_hw, out_hw, sample_hw):
    gen = torch.Generator(device=dev).manual_seed(2)
    labels = torch.randint(0, 4, tmpl_hw, generator=gen, device=dev, dtype=torch.uint8)
    theta = torch.eye(3, device=dev).repeat(5, 1, 1)
    theta[1:] += _rand(gen, (4, 3, 3), dev, 0.1)
    theta[3, 2] = torch.tensor([0.0, 0.0, -1e-9], device=dev)   # |z| <= eps: unscaled
    theta[4] = 0.0                                              # all points map to 0
    values = torch.arange(256, dtype=torch.float32, device=dev) * 0.25
    got = warp_nearest(labels, theta, out_hw, values, sample_hw)
    ref = warp_nearest_plain(labels, theta, out_hw, values, sample_hw)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_strided_inputs_and_side_stream(dev):
    """Non-contiguous inputs are made contiguous; launches go on the current
    stream, so work queued on a side stream is ordered with it."""
    gen = torch.Generator(device=dev).manual_seed(3)
    x_nchw = _rand(gen, (2, 16, 9, 11), dev)
    x = x_nchw.permute(0, 2, 3, 1)                       # NHWC view, not contiguous
    wt = _rand(gen, (3, 3, 16, 8), dev, 0.1)
    b = _rand(gen, (8,), dev)
    ref = conv3x3_plain(x.contiguous(), wt, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = conv3x3(x, wt, b)
        up = deconv2x2(got, _rand(gen, (8, 2, 2, 4), dev), b[:4])
    torch.cuda.current_stream().wait_stream(side)
    _close(got, ref, torch.float32)
    assert up.shape == (2, 18, 22, 4)


def test_launch_counters_and_device_mismatch(dev):
    before = conv3x3.launches
    x = torch.rand(1, 4, 4, 8, device=dev)
    conv3x3(x, torch.rand(3, 3, 8, 8, device=dev))
    assert conv3x3.launches == before + 1
    with pytest.raises(ValueError, match="different devices"):
        conv3x3(x, torch.rand(3, 3, 8, 8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        conv3x3(x.half(), torch.rand(3, 3, 8, 8, device=dev).half())
    assert conv3x3.launches == before + 1


# ---- training kernels: K2 stats, K5, K7-bwd, K3-bwd -------------------------

def _rel_l2(got, ref):
    got, ref = got.double(), ref.double()
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def _repeat(fn):
    """Two runs of a reduction kernel on the same inputs are bitwise equal."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    return a


_RED_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cin,cout,prologue", [
    (1, 7, 9, 3, 5, False),        # Cin = 3, ragged M and Cout
    (2, 33, 65, 48, 96, True),     # M, Cout not multiples of the 64x64 tile
    (3, 1, 1, 16, 64, True),       # 1x1 images
    (2, 45, 80, 64, 130, False),   # the 45x80 level, Cout over two tiles
])
def test_conv3x3_stats_edges(dev, dtype, n, h, w, cin, cout, prologue):
    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain

    gen = torch.Generator(device=dev).manual_seed(10)
    x = _rand(gen, (n, h, w, cin), dev).to(dtype)
    wt = _rand(gen, (3, 3, cin, cout), dev, 1.0 / (3 * cin ** 0.5))
    b = _rand(gen, (cout,), dev, 0.1)
    pro = ((_rand(gen, (cin,), dev, 0.1), torch.rand(cin, generator=gen, device=dev) + 0.5,
            _rand(gen, (cin,), dev, 0.1)) if prologue else None)
    y, s = _repeat(lambda: conv3x3(x, wt, b, pro, stats=True))
    if dtype == torch.float32:      # reductions against float64
        y_ref, s_ref = conv3x3_plain(x.double(), wt.double(), b.double(),
                                     None if pro is None else tuple(t.double() for t in pro),
                                     stats=True)
    else:                           # the plain version's f32 sums of the bf16 inputs
        y_ref, s_ref = conv3x3_plain(x, wt, b, pro, stats=True)
    assert y.dtype == dtype and s.shape == (2, cout)
    _close(y, y_ref, dtype)
    assert _rel_l2(s, s_ref) <= _RED_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cin,cout,prologue", [
    (1, 7, 9, 3, 5, False),
    (2, 33, 65, 48, 96, True),
    (3, 1, 1, 16, 64, True),
    (1, 45, 80, 200, 70, False),
])
def test_wgrad3x3_edges(dev, dtype, n, h, w, cin, cout, prologue):
    from sports_field_homography_tpu_torch.ops.wgrad3x3 import wgrad3x3, wgrad3x3_plain

    gen = torch.Generator(device=dev).manual_seed(11)
    x = _rand(gen, (n, h, w, cin), dev).to(dtype)
    dy = _rand(gen, (n, h, w, cout), dev).to(dtype)
    pro = ((_rand(gen, (cin,), dev, 0.1), torch.rand(cin, generator=gen, device=dev) + 0.5,
            _rand(gen, (cin,), dev, 0.1)) if prologue else None)
    dw, db = _repeat(lambda: wgrad3x3(x, dy, pro))
    if dtype == torch.float32:
        dw_ref, db_ref = wgrad3x3_plain(x.double(), dy.double(),
                                        None if pro is None else tuple(t.double() for t in pro))
    else:
        dw_ref, db_ref = wgrad3x3_plain(x, dy, pro)
    assert dw.shape == (3, 3, cin, cout) and dw.dtype == torch.float32
    assert _rel_l2(dw, dw_ref) <= _RED_TOL[dtype]
    assert _rel_l2(db, db_ref) <= _RED_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1, 1, 5), (2, 7, 9, 33), (3, 45, 80, 96)])
def test_bn_relu_bwd_edges(dev, dtype, shape):
    from sports_field_homography_tpu_torch.ops.bn_relu_bwd import bn_relu_bwd, bn_relu_bwd_plain

    gen = torch.Generator(device=dev).manual_seed(12)
    c = shape[-1]
    y = (_rand(gen, shape, dev, 2.0) + 0.3).to(dtype)
    g = _rand(gen, shape, dev).to(dtype)
    yf = y.float()
    mean = yf.mean(dim=(0, 1, 2))
    rstd = torch.rsqrt((yf * yf).mean(dim=(0, 1, 2)) - mean * mean + 1e-5)
    vecs = (mean, rstd, torch.rand(c, generator=gen, device=dev) + 0.5,
            _rand(gen, (c,), dev, 0.3))
    dx, dgam, dbet = _repeat(lambda: bn_relu_bwd(y, g, *vecs))
    dx_ref, _, _ = bn_relu_bwd_plain(y, g, *vecs)
    ref64 = bn_relu_bwd_plain(y.double(), g.double(), *(v.double() for v in vecs))
    _close(dx, dx_ref, dtype)
    assert _rel_l2(dgam, ref64[1]) <= 1e-5 and _rel_l2(dbet, ref64[2]) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1, 1, 5), (2, 7, 9, 33), (3, 45, 80, 96)])
def test_bn_relu_bwd_split_edges(dev, dtype, shape):
    """The data-parallel halves: the sums and dx with m_total = M equal the
    one-call entry bit for bit (the same kernels); dx from sums over more
    rows (another rank's share added) against the plain version."""
    from sports_field_homography_tpu_torch.ops.bn_relu_bwd import (
        bn_relu_bwd, bn_relu_bwd_dx, bn_relu_bwd_dx_plain, bn_relu_bwd_sums)

    gen = torch.Generator(device=dev).manual_seed(14)
    c, m = shape[-1], shape[0] * shape[1] * shape[2]
    y = (_rand(gen, shape, dev, 2.0) + 0.3).to(dtype)
    g = _rand(gen, shape, dev).to(dtype)
    yf = y.float()
    mean = yf.mean(dim=(0, 1, 2))
    rstd = torch.rsqrt((yf * yf).mean(dim=(0, 1, 2)) - mean * mean + 1e-5)
    vecs = (mean, rstd, torch.rand(c, generator=gen, device=dev) + 0.5,
            _rand(gen, (c,), dev, 0.3))
    dx, dgam, dbet = bn_relu_bwd(y, g, *vecs)
    sums, = _repeat(lambda: bn_relu_bwd_sums(y, g, *vecs))
    assert torch.equal(sums, torch.cat([dbet, dgam]))
    assert torch.equal(bn_relu_bwd_dx(y, g, *vecs, sums, m), dx)
    total = sums + _rand(gen, (2 * c,), dev, float(m) ** 0.5)
    got = bn_relu_bwd_dx(y, g, *vecs, total, 3 * m)
    _close(got, bn_relu_bwd_dx_plain(y, g, *vecs, total, 3 * m), dtype)
    with pytest.raises(ValueError, match="m_total"):
        bn_relu_bwd_dx(y, g, *vecs, sums, m - 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cin,cout", [(1, 5, 7, 24, 10), (2, 22, 40, 128, 64),
                                            (1, 1, 1, 8, 3), (2, 45, 80, 64, 32)])
def test_deconv_backward_edges(dev, dtype, n, h, w, cin, cout):
    from sports_field_homography_tpu_torch.ops.deconv import (deconv2x2_backward,
                                                              deconv2x2_backward_plain)

    gen = torch.Generator(device=dev).manual_seed(13)
    x = _rand(gen, (n, h, w, cin), dev).to(dtype)
    dy = _rand(gen, (n, 2 * h, 2 * w, cout), dev).to(dtype)
    wt = _rand(gen, (cin, 2, 2, cout), dev, cin ** -0.5).to(dtype)
    dx, dw, db = _repeat(lambda: deconv2x2_backward(x, dy, wt))
    dx_ref, _, _ = deconv2x2_backward_plain(x, dy, wt)
    if dtype == torch.float32:
        _, dw_ref, db_ref = deconv2x2_backward_plain(x.double(), dy.double(), wt.double())
    else:
        _, dw_ref, db_ref = deconv2x2_backward_plain(x, dy, wt)
    assert dx.dtype == dtype and dw.shape == (cin, 2, 2, cout)
    _close(dx, dx_ref, dtype)
    assert _rel_l2(dw, dw_ref) <= _RED_TOL[dtype]
    assert _rel_l2(db, db_ref) <= _RED_TOL[dtype]


def test_training_kernels_strided_inputs_and_side_stream(dev):
    """Non-contiguous inputs (an NCHW tensor's NHWC view, a sliced
    cotangent) are made contiguous; every launch goes on the current
    stream, so work queued on a side stream is ordered with it."""
    from sports_field_homography_tpu_torch.ops.bn_relu_bwd import bn_relu_bwd, bn_relu_bwd_plain
    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain
    from sports_field_homography_tpu_torch.ops.deconv import (deconv2x2_backward,
                                                              deconv2x2_backward_plain)
    from sports_field_homography_tpu_torch.ops.wgrad3x3 import wgrad3x3, wgrad3x3_plain

    gen = torch.Generator(device=dev).manual_seed(14)
    x = _rand(gen, (2, 16, 9, 11), dev).permute(0, 2, 3, 1)          # (2, 9, 11, 16)
    dy = _rand(gen, (2, 9, 13, 8), dev)[:, :, 1:12]                  # (2, 9, 11, 8)
    wt = _rand(gen, (3, 3, 16, 8), dev, 0.1)
    b = _rand(gen, (8,), dev)
    vecs = (_rand(gen, (8,), dev, 0.1), torch.rand(8, generator=gen, device=dev) + 0.5,
            torch.rand(8, generator=gen, device=dev) + 0.5, _rand(gen, (8,), dev, 0.1))
    wd = _rand(gen, (16, 2, 2, 4), dev, 0.25)
    gd = _rand(gen, (2, 20, 22, 4), dev)[:, :18]                     # (2, 18, 22, 4)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y, s = conv3x3(x, wt, b, stats=True)
        dw, db = wgrad3x3(x, dy)
        dxb = bn_relu_bwd(y, dy, *vecs)
        dxd = deconv2x2_backward(x, gd, wd)
    torch.cuda.current_stream().wait_stream(side)
    xc, dyc = x.contiguous(), dy.contiguous()
    y_ref, s_ref = conv3x3_plain(xc, wt, b, stats=True)
    _close(y, y_ref, torch.float32)
    assert _rel_l2(s, s_ref) <= 1e-5
    assert _rel_l2(dw, wgrad3x3_plain(xc, dyc)[0]) <= 1e-5
    _close(dxb[0], bn_relu_bwd_plain(y_ref, dyc, *vecs)[0], torch.float32)
    for got, ref in zip(dxd, deconv2x2_backward_plain(xc, gd.contiguous(), wd)):
        _close(got, ref, torch.float32)


def test_training_kernel_counters_and_refusals(dev):
    from sports_field_homography_tpu_torch.ops.bn_relu_bwd import bn_relu_bwd
    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3
    from sports_field_homography_tpu_torch.ops.deconv import deconv2x2_backward
    from sports_field_homography_tpu_torch.ops.wgrad3x3 import wgrad3x3

    x = torch.rand(1, 4, 4, 8, device=dev)
    before = (conv3x3.launches, conv3x3.stats_launches, wgrad3x3.launches,
              bn_relu_bwd.launches, deconv2x2_backward.launches)
    conv3x3(x, torch.rand(3, 3, 8, 8, device=dev), stats=True)
    wgrad3x3(x, x)
    v = torch.ones(8, device=dev)
    bn_relu_bwd(x, x, v, v, v, v)
    deconv2x2_backward(x, torch.rand(1, 8, 8, 2, device=dev), torch.rand(8, 2, 2, 2, device=dev))
    after = (conv3x3.launches, conv3x3.stats_launches, wgrad3x3.launches,
             bn_relu_bwd.launches, deconv2x2_backward.launches)
    assert all(a == b + 1 for a, b in zip(after, before))
    with pytest.raises(TypeError, match="dtype"):
        wgrad3x3(x, x.bfloat16())
    with pytest.raises(ValueError, match="different devices"):
        bn_relu_bwd(x, x, v.cpu(), v, v, v)
    with pytest.raises(ValueError, match="dy must be"):
        deconv2x2_backward(x, torch.rand(1, 7, 8, 2, device=dev), torch.rand(8, 2, 2, 2, device=dev))


# ---- K7-fwd (BN+ReLU stats and norm), K2's two-input form -------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 7, 9, 64), (1, 33, 65, 96), (3, 5, 7, 1024),
                                   (2, 3, 5, 5)])   # C = 5: the scalar (unvectorised) path
def test_bn_relu_fwd_edges(dev, dtype, shape):
    """Pixel counts that fill no block evenly; f32 norm equal to the plain
    version bit for bit, bf16 within 2e-2; stats against float64 (f32) or
    the plain version (bf16), repeated bitwise."""
    from sports_field_homography_tpu_torch.ops.bn_relu import (
        bn_relu_norm, bn_relu_norm_plain, bn_relu_stats, bn_relu_stats_plain)

    gen = torch.Generator(device=dev).manual_seed(20)
    c = shape[-1]
    x = (_rand(gen, shape, dev, 2.0) + 0.4).to(dtype)
    (s,) = _repeat(lambda: bn_relu_stats(x))
    ref = bn_relu_stats_plain(x.double() if dtype == torch.float32 else x)
    assert s.shape == (2, c) and s.dtype == torch.float32
    assert _rel_l2(s, ref) <= _RED_TOL[dtype]
    mean, inv, beta = (_rand(gen, (c,), dev, 0.3), torch.rand(c, generator=gen, device=dev) + 0.5,
                       _rand(gen, (c,), dev, 0.3))
    y = bn_relu_norm(x, mean, inv, beta)
    y_ref = bn_relu_norm_plain(x, mean, inv, beta)
    assert y.dtype == dtype and y.shape == x.shape
    if dtype == torch.float32:
        assert torch.equal(y, y_ref)
    _close(y, y_ref, dtype)


def test_bn_relu_fwd_strided_offset_input(dev):
    """A channel slice (not 16-byte aligned, not contiguous) is made
    contiguous; the result matches the plain version."""
    from sports_field_homography_tpu_torch.ops.bn_relu import (
        bn_relu_norm, bn_relu_norm_plain, bn_relu_stats, bn_relu_stats_plain)

    gen = torch.Generator(device=dev).manual_seed(21)
    x = _rand(gen, (2, 9, 11, 70), dev)[..., 3:67]
    v = (_rand(gen, (64,), dev, 0.1), torch.rand(64, generator=gen, device=dev) + 0.5,
         _rand(gen, (64,), dev, 0.1))
    assert torch.equal(bn_relu_norm(x, *v), bn_relu_norm_plain(x.contiguous(), *v))
    assert _rel_l2(bn_relu_stats(x), bn_relu_stats_plain(x.double())) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_relu_train_function(dev, dtype):
    """bn_relu_train on the card (K7-fwd, then K7-bwd in its backward)
    against the same Function's plain versions on the CPU."""
    from sports_field_homography_tpu_torch.ops.bn_relu import bn_relu_train

    gen = torch.Generator(device=dev).manual_seed(22)
    x = (_rand(gen, (2, 13, 17, 96), dev, 2.0) + 0.3).to(dtype)
    g, b = torch.rand(96, generator=gen, device=dev) + 0.5, _rand(gen, (96,), dev, 0.2)
    cot = _rand(gen, (2, 13, 17, 96), dev).to(dtype)
    runs = {}
    for d in ("cuda", "cpu"):
        xs, gs, bs = (t.detach().to(d).requires_grad_() for t in (x, g, b))
        y, mean, var = bn_relu_train(xs, gs, bs)
        y.backward(cot.to(d))
        runs[d] = (y, mean, var, xs.grad, gs.grad, bs.grad)
    for got, ref in zip(runs["cuda"][:4], runs["cpu"][:4]):
        _close(got.cpu(), ref, dtype)
    for got, ref in zip(runs["cuda"][4:], runs["cpu"][4:]):
        assert _rel_l2(got.cpu(), ref) <= _RED_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,ca,cb,cout,prologue", [
    (2, 33, 65, 48, 80, 96, True),     # Ca != Cb, ragged tiles, prologue on x only
    (2, 1, 37, 16, 8, 33, False),      # a 1-row image
    (2, 45, 80, 64, 64, 64, False),    # the level-4 skip of a 640x360 frame
])
def test_conv3x3_two_input_edges(dev, dtype, n, h, w, ca, cb, cout, prologue):
    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain

    gen = torch.Generator(device=dev).manual_seed(23)
    a = _rand(gen, (n, h, w, ca), dev).to(dtype)
    b = _rand(gen, (n, h, w, cb), dev).to(dtype)
    wa = _rand(gen, (3, 3, ca, cout), dev, 1.0 / (3 * (ca + cb) ** 0.5))
    wb = _rand(gen, (3, 3, cb, cout), dev, 1.0 / (3 * (ca + cb) ** 0.5))
    bias = _rand(gen, (cout,), dev, 0.1)
    pro = ((_rand(gen, (ca,), dev, 0.1), torch.rand(ca, generator=gen, device=dev) + 0.5,
            _rand(gen, (ca,), dev, 0.1)) if prologue else None)
    y, s = _repeat(lambda: conv3x3(a, wa, bias, pro, stats=True, x2=b, w2=wb))
    if dtype == torch.float32:
        y_ref, s_ref = conv3x3_plain(a.double(), wa.double(), bias.double(),
                                     None if pro is None else tuple(t.double() for t in pro),
                                     stats=True, x2=b.double(), w2=wb.double())
    else:
        y_ref, s_ref = conv3x3_plain(a, wa, bias, pro, stats=True, x2=b, w2=wb)
    assert y.dtype == dtype and y.shape == (n, h, w, cout)
    _close(y, y_ref, dtype)
    assert _rel_l2(s, s_ref) <= _RED_TOL[dtype]
    _close(conv3x3(a, wa, bias, pro, x2=b, w2=wb), y_ref, dtype)


def test_skip_after_odd_pad_two_input(dev):
    """The decoder's level-4 case: a 22x40 input up-sampled to 44x80 and
    padded to the 45x80 skip, then the two-input conv and DoubleConv on
    the card against the CPU."""
    import torch.nn.functional as F

    from sports_field_homography_tpu_torch.ops.double_conv import double_conv_train
    from sports_field_homography_tpu_torch.ops.resize import upsample2x_bilinear

    gen = torch.Generator(device=dev).manual_seed(24)
    skip = _rand(gen, (2, 45, 80, 32), dev)
    up = F.pad(upsample2x_bilinear(_rand(gen, (2, 22, 40, 32), dev)), (0, 0, 0, 0, 0, 1))
    params = [_rand(gen, (3, 3, 64, 16), dev, 0.05), _rand(gen, (16,), dev, 0.1),
              torch.rand(16, generator=gen, device=dev) + 0.5, _rand(gen, (16,), dev, 0.1),
              _rand(gen, (3, 3, 16, 24), dev, 0.1), _rand(gen, (24,), dev, 0.1),
              torch.rand(24, generator=gen, device=dev) + 0.5, _rand(gen, (24,), dev, 0.1)]
    cot = _rand(gen, (2, 45, 80, 24), dev)
    runs = {}
    for d in ("cuda", "cpu"):
        xs = [t.detach().to(d).requires_grad_() for t in [skip, up] + params]
        out = double_conv_train(xs[0], *xs[2:], x2=xs[1])
        out[0].backward(cot.to(d))
        runs[d] = [out[0].detach()] + [t.grad for t in xs]
    _close(runs["cuda"][0].cpu(), runs["cpu"][0], torch.float32)
    # 1e-3: a ReLU mask bit whose pre-activation lies within an ulp of 0
    # follows the last bit of the batch statistics and moves a gradient.
    # Not compared: the conv biases b1, b2 (runs[4], runs[8]), which feed a
    # train-mode BN, so their true gradient is 0 and both hold rounding noise.
    for i, (got, ref) in enumerate(zip(runs["cuda"], runs["cpu"])):
        if i not in (0, 4, 8):
            assert _rel_l2(got.cpu(), ref) <= 1e-3, i


def test_fwd_kernel_counters_and_refusals(dev):
    from sports_field_homography_tpu_torch.ops.bn_relu import bn_relu_norm, bn_relu_stats
    from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3

    x = torch.rand(1, 4, 4, 8, device=dev)
    v = torch.ones(8, device=dev)
    before = (bn_relu_stats.launches, bn_relu_norm.launches, conv3x3.dual_launches,
              conv3x3.launches)
    bn_relu_stats(x)
    bn_relu_norm(x, v, v, v)
    conv3x3(x, torch.rand(3, 3, 8, 4, device=dev), x2=x, w2=torch.rand(3, 3, 8, 4, device=dev))
    after = (bn_relu_stats.launches, bn_relu_norm.launches, conv3x3.dual_launches,
             conv3x3.launches)
    assert all(a == b + 1 for a, b in zip(after, before))
    with pytest.raises(TypeError, match="x2"):
        conv3x3(x, torch.rand(3, 3, 8, 4, device=dev), x2=x.bfloat16(),
                w2=torch.rand(3, 3, 8, 4, device=dev))
    with pytest.raises(ValueError, match="different devices"):
        bn_relu_norm(x, v.cpu(), v, v)
    big = torch.rand(1, 1, 1, 4097, device=dev)
    with pytest.raises(ValueError, match="at most"):
        bn_relu_norm(big, *(torch.ones(4097, device=dev),) * 3)


# ---- K2 and K5 on the tensor cores (bf16, channel counts multiples of 64) ----

def _routed(kernel, tc, fn):
    """fn() launches ``kernel``; every launch on the tensor-core route when
    ``tc``, none otherwise."""
    n0, t0 = kernel.launches, kernel.tc_launches
    out = fn()
    n, t = kernel.launches - n0, kernel.tc_launches - t0
    assert n > 0 and t == (n if tc else 0), (n, t)
    return out


@pytest.mark.parametrize("n,h,w,ca,cb,cout,prologue", [
    (2, 33, 65, 64, 0, 64, True),       # ragged M
    (2, 22, 40, 512, 0, 512, False),    # the 22x40 level, BN = 128 tiles
    (3, 1, 1, 1024, 0, 64, True),       # 1x1 images: every tap but the centre is padding
    (1, 7, 9, 64, 0, 192, False),       # Cout over a 128 and a 64 multiple (BN = 64)
    (2, 33, 65, 64, 128, 64, True),     # two inputs, Ca != Cb, prologue on x only
    (1, 22, 40, 512, 64, 512, False),   # two inputs, the deep level
])
def test_conv3x3_tensor_core_edges(dev, n, h, w, ca, cb, cout, prologue):
    gen = torch.Generator(device=dev).manual_seed(30)
    x = _rand(gen, (n, h, w, ca), dev).bfloat16()
    x2 = _rand(gen, (n, h, w, cb), dev).bfloat16() if cb else None
    wt = _rand(gen, (3, 3, ca, cout), dev, 1.0 / (3 * (ca + cb) ** 0.5)).bfloat16()
    w2 = _rand(gen, (3, 3, cb, cout), dev, 1.0 / (3 * (ca + cb) ** 0.5)).bfloat16() if cb else None
    bias = _rand(gen, (cout,), dev, 0.1)
    pro = ((_rand(gen, (ca,), dev, 0.1), torch.rand(ca, generator=gen, device=dev) + 0.5,
            _rand(gen, (ca,), dev, 0.1)) if prologue else None)
    y, s = _routed(conv3x3, True, lambda: _repeat(
        lambda: conv3x3(x, wt, bias, pro, stats=True, x2=x2, w2=w2)))
    y_ref, s_ref = conv3x3_plain(x, wt, bias, pro, stats=True, x2=x2, w2=w2)
    assert y.dtype == torch.bfloat16 and y.shape == (n, h, w, cout)
    _close(y, y_ref, torch.bfloat16)
    assert _rel_l2(s, s_ref) <= _RED_TOL[torch.bfloat16]
    _close(_routed(conv3x3, True, lambda: conv3x3(x, wt, bias, pro, x2=x2, w2=w2)), y_ref,
           torch.bfloat16)


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 33, 65, 128, 64), (2, 45, 80, 1024, 512),
                                            (3, 1, 1, 64, 512)])
def test_conv3x3_tensor_core_dgrad(dev, n, h, w, cin, cout):
    """The dgrad: K2 over the cotangent with dgrad_weights (a flipped,
    transposed view), no bias, on the tensor cores."""
    from sports_field_homography_tpu_torch.ops.conv3x3 import dgrad_weights

    gen = torch.Generator(device=dev).manual_seed(31)
    dy = _rand(gen, (n, h, w, cin), dev).bfloat16()
    wd = dgrad_weights(_rand(gen, (3, 3, cout, cin), dev, 1.0 / (3 * cin ** 0.5)).bfloat16())
    got = _routed(conv3x3, True, lambda: conv3x3(dy, wd))
    _close(got, conv3x3_plain(dy, wd), torch.bfloat16)


@pytest.mark.parametrize("n,h,w,cin,cout,prologue", [
    (2, 33, 65, 64, 64, True), (2, 22, 40, 512, 512, False), (3, 1, 1, 1024, 64, True),
    (1, 45, 80, 64, 512, False), (1, 7, 9, 128, 192, True)])
def test_wgrad3x3_tensor_core_edges(dev, n, h, w, cin, cout, prologue):
    from sports_field_homography_tpu_torch.ops.wgrad3x3 import wgrad3x3, wgrad3x3_plain

    gen = torch.Generator(device=dev).manual_seed(32)
    x = _rand(gen, (n, h, w, cin), dev).bfloat16()
    dy = _rand(gen, (n, h, w, cout), dev).bfloat16()
    pro = ((_rand(gen, (cin,), dev, 0.1), torch.rand(cin, generator=gen, device=dev) + 0.5,
            _rand(gen, (cin,), dev, 0.1)) if prologue else None)
    dw, db = _routed(wgrad3x3, True, lambda: _repeat(lambda: wgrad3x3(x, dy, pro)))
    dw_ref, db_ref = wgrad3x3_plain(x, dy, pro)
    assert dw.shape == (3, 3, cin, cout) and dw.dtype == torch.float32
    assert _rel_l2(dw, dw_ref) <= _RED_TOL[torch.bfloat16]
    assert _rel_l2(db, db_ref) <= _RED_TOL[torch.bfloat16]


def test_tensor_core_skip_after_odd_pad_two_input(dev):
    """The decoder's 45x80 skip after the odd pad (a 22x40 input up-sampled
    to 44x80, padded by one row) through the two-input conv with stats and
    both wgrads, bf16 on the tensor cores."""
    import torch.nn.functional as F

    from sports_field_homography_tpu_torch.ops.resize import upsample2x_bilinear
    from sports_field_homography_tpu_torch.ops.wgrad3x3 import wgrad3x3, wgrad3x3_plain

    gen = torch.Generator(device=dev).manual_seed(33)
    skip = _rand(gen, (2, 45, 80, 64), dev).bfloat16()
    up = F.pad(upsample2x_bilinear(_rand(gen, (2, 22, 40, 128), dev).bfloat16()),
               (0, 0, 0, 0, 0, 1))
    wa = _rand(gen, (3, 3, 64, 64), dev, 0.03).bfloat16()
    wb = _rand(gen, (3, 3, 128, 64), dev, 0.03).bfloat16()
    bias = _rand(gen, (64,), dev, 0.1)
    y, s = _routed(conv3x3, True, lambda: conv3x3(skip, wa, bias, stats=True, x2=up, w2=wb))
    y_ref, s_ref = conv3x3_plain(skip, wa, bias, stats=True, x2=up, w2=wb)
    _close(y, y_ref, torch.bfloat16)
    assert _rel_l2(s, s_ref) <= _RED_TOL[torch.bfloat16]
    for inp in (skip, up):
        dw, _ = _routed(wgrad3x3, True, lambda: wgrad3x3(inp, y))
        assert _rel_l2(dw, wgrad3x3_plain(inp, y)[0]) <= _RED_TOL[torch.bfloat16]


def test_tensor_core_strided_inputs_and_side_stream(dev):
    """Non-contiguous bf16 inputs (an NCHW tensor's NHWC view, a channel
    slice off the 16-byte grid) are made contiguous and aligned; the
    tensor-core launches go on the current stream."""
    from sports_field_homography_tpu_torch.ops.wgrad3x3 import wgrad3x3, wgrad3x3_plain

    gen = torch.Generator(device=dev).manual_seed(34)
    x = _rand(gen, (2, 64, 9, 11), dev).bfloat16().permute(0, 2, 3, 1)      # (2, 9, 11, 64)
    dy = _rand(gen, (2, 9, 11, 131), dev).bfloat16()[..., 3:131]              # (2, 9, 11, 128)
    wt = _rand(gen, (3, 3, 64, 128), dev, 0.05).bfloat16()
    b = _rand(gen, (128,), dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = _routed(conv3x3, True, lambda: conv3x3(x, wt, b))
        dw, db = _routed(wgrad3x3, True, lambda: wgrad3x3(x, dy))
    torch.cuda.current_stream().wait_stream(side)
    xc, dyc = x.contiguous(), dy.contiguous()
    _close(y, conv3x3_plain(xc, wt, b), torch.bfloat16)
    dw_ref, db_ref = wgrad3x3_plain(xc, dyc)
    assert _rel_l2(dw, dw_ref) <= 1e-3 and _rel_l2(db, db_ref) <= 1e-3


def test_route_counters(dev):
    """bf16 with channels in multiples of 64 counts a tensor-core launch; an
    odd channel count in bf16 and every f32 call do not."""
    from sports_field_homography_tpu_torch.ops.wgrad3x3 import wgrad3x3

    gen = torch.Generator(device=dev).manual_seed(35)
    x64, x48 = _rand(gen, (1, 5, 6, 64), dev), _rand(gen, (1, 5, 6, 48), dev)
    w64, w48 = _rand(gen, (3, 3, 64, 64), dev, 0.05), _rand(gen, (3, 3, 48, 64), dev, 0.05)
    _routed(conv3x3, True, lambda: conv3x3(x64.bfloat16(), w64))
    _routed(conv3x3, False, lambda: conv3x3(x64, w64))
    _routed(conv3x3, False, lambda: conv3x3(x48.bfloat16(), w48))
    _routed(conv3x3, False, lambda: conv3x3(x64.bfloat16(), w64, x2=x48.bfloat16(), w2=w48))
    dy = _rand(gen, (1, 5, 6, 64), dev)
    _routed(wgrad3x3, True, lambda: wgrad3x3(x64.bfloat16(), dy.bfloat16()))
    _routed(wgrad3x3, False, lambda: wgrad3x3(x64, dy))
    _routed(wgrad3x3, False, lambda: wgrad3x3(x48.bfloat16(), dy.bfloat16()))


@pytest.mark.parametrize("sample_hw", [None, (18, 32)])
def test_warp_gap_template(dev, sample_hw):
    """K1 on a template that skips a label ({0, 2} of 4 classes): equal to
    the plain version bit for bit, label 2 worth the interval table's 0.5."""
    from sports_field_homography_tpu_torch.ops.warp import template_value_table

    gen = torch.Generator(device=dev).manual_seed(36)
    labels = np.zeros((36, 64), np.uint8)
    labels[5:31, 8:56] = 2
    values = template_value_table(labels, 4).to(dev)
    theta = torch.eye(3, device=dev).repeat(4, 1, 1)
    theta[1:] += _rand(gen, (3, 3, 3), dev, 0.05)
    tmpl = torch.from_numpy(labels).to(dev)
    got = warp_nearest(tmpl, theta, (36, 64), values, sample_hw)
    ref = warp_nearest_plain(tmpl, theta, (36, 64), values, sample_hw)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert float(got.max()) == 0.5


# ---- K3 and K3-bwd on the tensor cores (bf16, Cin and Cout multiples of 64) --

@pytest.mark.parametrize("n,h,w,cin,cout", [
    (1, 5, 7, 64, 64),          # M = 35: one ragged row block
    (2, 45, 80, 128, 64),       # M = 7200, not a multiple of 128
    (1, 1, 1, 64, 128),         # one pixel; the dgrad's BN = 64 tiles
    (1, 3, 5, 1024, 512),       # the deepest up-conv's channels at a small odd size
    (2, 7, 9, 64, 192),         # Cout not a multiple of 128: wgrad BN = 64
])
def test_deconv_tensor_core_edges(dev, n, h, w, cin, cout):
    from sports_field_homography_tpu_torch.ops.deconv import (deconv2x2_backward,
                                                              deconv2x2_backward_plain)

    gen = torch.Generator(device=dev).manual_seed(37)
    x = _rand(gen, (n, h, w, cin), dev).bfloat16()
    wt = _rand(gen, (cin, 2, 2, cout), dev, cin ** -0.5).bfloat16()
    b = _rand(gen, (cout,), dev, 0.1)
    dy = _rand(gen, (n, 2 * h, 2 * w, cout), dev).bfloat16()
    y = _routed(deconv2x2, True, lambda: deconv2x2(x, wt, b))
    assert y.dtype == torch.bfloat16 and y.shape == (n, 2 * h, 2 * w, cout)
    _close(y, deconv2x2_plain(x.float(), wt.float(), b), torch.bfloat16)
    dx, dw, db = _routed(deconv2x2_backward, True,
                         lambda: _repeat(lambda: deconv2x2_backward(x, dy, wt)))
    dx_ref, dw_ref, db_ref = deconv2x2_backward_plain(x, dy, wt)
    assert dx.dtype == torch.bfloat16 and dw.shape == (cin, 2, 2, cout) and dw.dtype == torch.float32
    _close(dx, dx_ref, torch.bfloat16)
    assert _rel_l2(dw, dw_ref) <= _RED_TOL[torch.bfloat16]
    assert _rel_l2(db, db_ref) <= _RED_TOL[torch.bfloat16]


def test_deconv_tensor_core_autograd_sliced_cotangent(dev):
    """deconv2x2 under autograd on the tensor cores, padded to an odd skip
    as the UNet pads it, so that K3-bwd's cotangent is a slice of the
    padded gradient; on a side stream."""
    import torch.nn.functional as F

    from sports_field_homography_tpu_torch.ops.deconv import (deconv2x2_backward,
                                                              deconv2x2_backward_plain)

    gen = torch.Generator(device=dev).manual_seed(38)
    x = _rand(gen, (2, 22, 40, 128), dev).bfloat16().requires_grad_()
    wt = _rand(gen, (128, 2, 2, 64), dev, 128 ** -0.5).requires_grad_()   # f32, as a parameter
    b = _rand(gen, (64,), dev, 0.1).requires_grad_()
    g = _rand(gen, (2, 45, 81, 64), dev).bfloat16()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = _routed(deconv2x2, True, lambda: deconv2x2(x, wt, b))
        _routed(deconv2x2_backward, True,
                lambda: F.pad(y, (0, 0, 0, 1, 0, 1)).backward(g))
    torch.cuda.current_stream().wait_stream(side)
    dx_ref, dw_ref, db_ref = deconv2x2_backward_plain(x.detach(), g[:, :44, :80], wt.detach())
    _close(x.grad, dx_ref, torch.bfloat16)
    assert _rel_l2(wt.grad, dw_ref) <= _RED_TOL[torch.bfloat16]
    assert _rel_l2(b.grad, db_ref) <= _RED_TOL[torch.bfloat16]


def test_deconv_route_counters(dev):
    """bf16 with Cin and Cout multiples of 64 counts a tensor-core K3 or
    K3-bwd launch; an odd channel count in bf16 and every f32 call do not."""
    from sports_field_homography_tpu_torch.ops.deconv import deconv2x2_backward

    gen = torch.Generator(device=dev).manual_seed(39)
    x64, x48 = _rand(gen, (1, 5, 6, 64), dev), _rand(gen, (1, 5, 6, 48), dev)
    w64, w48 = _rand(gen, (64, 2, 2, 64), dev, 0.1), _rand(gen, (48, 2, 2, 64), dev, 0.1)
    b, dy = _rand(gen, (64,), dev), _rand(gen, (1, 10, 12, 64), dev)
    bf = torch.bfloat16
    _routed(deconv2x2, True, lambda: deconv2x2(x64.to(bf), w64.to(bf), b))
    _routed(deconv2x2, False, lambda: deconv2x2(x64, w64, b))
    _routed(deconv2x2, False, lambda: deconv2x2(x48.to(bf), w48.to(bf), b))
    _routed(deconv2x2_backward, True,
            lambda: deconv2x2_backward(x64.to(bf), dy.to(bf), w64.to(bf)))
    _routed(deconv2x2_backward, False, lambda: deconv2x2_backward(x64, dy, w64))
    _routed(deconv2x2_backward, False,
            lambda: deconv2x2_backward(x48.to(bf), dy.to(bf), w48.to(bf)))


# ---- K1 and K7-bwd routes: 16-byte vectors where the shapes allow ------------

def _vec_routed(kernel, vec, fn):
    """fn() calls ``kernel`` (``warp_nearest`` or ``bn_relu_bwd``); every
    call on the 16-byte route when ``vec``, none otherwise."""
    n0, v0 = kernel.launches, kernel.vec_launches
    out = fn()
    n, v = kernel.launches - n0, kernel.vec_launches - v0
    assert n > 0 and v == (n if vec else 0), (n, v)
    return out


@pytest.mark.parametrize("b,out_hw,sample_hw,vec", [
    (1, (720, 1280), (360, 640), True),       # predict's sampled grid, one image
    (26, (720, 1280), (360, 640), True),      # the conf's batch
    (26, (360, 640), None, True),             # the test CLI's full grid
    (3, (37, 642), None, False),              # Wo % 4 == 2: one float a store
    (2, (720, 1280), (359, 641), False),      # Ws % 4 == 1
])
def test_warp_routes(dev, b, out_hw, sample_hw, vec):
    """K1 labels equal the plain version's on both store routes, from a
    non-contiguous template and a (B, 1, 3, 3) theta; B = 1 and 26.  The
    wrapper allocates the output itself, so no offset output view reaches
    the kernel."""
    gen = torch.Generator(device=dev).manual_seed(40)
    big = torch.randint(0, 4, (722, 1283), generator=gen, device=dev, dtype=torch.uint8)
    labels = big[1:721, 2:1282]                                  # (720, 1280) view
    theta = torch.eye(3, device=dev).repeat(b, 1, 1)
    theta += _rand(gen, (b, 3, 3), dev, 0.1) * torch.tensor(
        [[1.0, 1.0, 2.0], [1.0, 1.0, 2.0], [0.5, 0.5, 0.0]], device=dev)
    if b > 2:
        theta[1, 2] = torch.tensor([0.0, 0.0, -1e-9], device=dev)   # |z| <= eps
        theta[2] = 0.0
    values = torch.arange(256, dtype=torch.float32, device=dev) * 0.25
    got = _vec_routed(warp_nearest, vec,
                      lambda: warp_nearest(labels, theta[:, None], out_hw, values, sample_hw))
    ref = warp_nearest_plain(labels.contiguous(), theta, out_hw, values, sample_hw)
    assert got.shape == (b,) + tuple(sample_hw or out_hw)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def _bn_inputs(gen, shape, dtype, dev, offset=0):
    """y, g and the per-channel vectors; ``offset`` > 0 puts y and g that
    many elements into their buffers (contiguous views off the 16-byte
    grid)."""
    c, numel = shape[-1], int(np.prod(shape))

    def buf(scale, shift):
        t = torch.empty(numel + offset, device=dev, dtype=dtype)
        t[offset:] = (_rand(gen, (numel,), dev, scale) + shift).to(dtype)
        return t[offset:].view(shape)

    y, g = buf(2.0, 0.3), buf(1.0, 0.0)
    yf = y.float()
    mean = yf.mean(dim=(0, 1, 2))
    rstd = torch.rsqrt((yf * yf).mean(dim=(0, 1, 2)) - mean * mean + 1e-5)
    return y, g, (mean, rstd, torch.rand(c, generator=gen, device=dev) + 0.5,
                  _rand(gen, (c,), dev, 0.3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset,vec", [
    ((2, 7, 9, 8), 0, True),            # one channel group
    ((2, 33, 65, 64), 0, True),
    ((1, 45, 80, 72), 0, True),         # 9 (bf16) or 18 (f32) groups: 256 threads do not divide
    ((2, 5, 7, 1024), 0, True),         # 128 (bf16) or 256 (f32) groups, one or two row lanes
    ((3, 97, 101, 64), 0, True),        # M = 29,391: the last chunk is ragged
    ((1, 1, 1, 5), 0, False),
    ((2, 7, 9, 33), 0, False),
    ((3, 45, 80, 96), 1, False),        # C = 96 from a view off the 16-byte grid
])
def test_bn_relu_bwd_routes(dev, dtype, shape, offset, vec):
    from sports_field_homography_tpu_torch.ops.bn_relu_bwd import bn_relu_bwd, bn_relu_bwd_plain

    y, g, vecs = _bn_inputs(torch.Generator(device=dev).manual_seed(41), shape, dtype, dev,
                            offset)
    dx, dgam, dbet = _vec_routed(bn_relu_bwd, vec, lambda: _repeat(lambda: bn_relu_bwd(y, g, *vecs)))
    dx_ref, _, _ = bn_relu_bwd_plain(y, g, *vecs)
    ref64 = bn_relu_bwd_plain(y.double(), g.double(), *(v.double() for v in vecs))
    assert dx.dtype == dtype and dx.shape == shape
    _close(dx, dx_ref, dtype)
    assert _rel_l2(dgam, ref64[1]) <= 1e-5 and _rel_l2(dbet, ref64[2]) <= 1e-5


def test_bn_relu_bwd_batch26_deep_level(dev):
    """The conf's batch 26 at the 45x80x512 level, bf16, vector route."""
    from sports_field_homography_tpu_torch.ops.bn_relu_bwd import bn_relu_bwd, bn_relu_bwd_plain

    y, g, vecs = _bn_inputs(torch.Generator(device=dev).manual_seed(42), (26, 45, 80, 512),
                            torch.bfloat16, dev)
    dx, dgam, dbet = _vec_routed(bn_relu_bwd, True, lambda: _repeat(lambda: bn_relu_bwd(y, g, *vecs)))
    dx_ref, dgam_ref, dbet_ref = bn_relu_bwd_plain(y, g, *vecs)
    _close(dx, dx_ref, torch.bfloat16)
    assert _rel_l2(dgam, dgam_ref) <= _RED_TOL[torch.bfloat16]
    assert _rel_l2(dbet, dbet_ref) <= _RED_TOL[torch.bfloat16]


def test_bn_relu_bwd_side_stream(dev):
    """The three launches go on the current stream: a call on a side stream
    equals the same call on the default stream bit for bit."""
    from sports_field_homography_tpu_torch.ops.bn_relu_bwd import bn_relu_bwd

    y, g, vecs = _bn_inputs(torch.Generator(device=dev).manual_seed(43), (8, 45, 80, 64),
                            torch.bfloat16, dev)
    want = bn_relu_bwd(y, g, *vecs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = _vec_routed(bn_relu_bwd, True, lambda: bn_relu_bwd(y, g, *vecs))
    torch.cuda.current_stream().wait_stream(side)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_k1_k7bwd_replay_in_a_cuda_graph(dev):
    """Both wrappers launch on the capturing stream, so a CUDA graph of
    their calls (how the smoke run times the bare kernels) replays to the
    eager results."""
    from sports_field_homography_tpu_torch.ops.bn_relu_bwd import bn_relu_bwd

    gen = torch.Generator(device=dev).manual_seed(44)
    labels = torch.randint(0, 4, (72, 128), generator=gen, device=dev, dtype=torch.uint8)
    theta = torch.eye(3, device=dev).repeat(2, 1, 1) + _rand(gen, (2, 3, 3), dev, 0.05)
    values = torch.arange(256, dtype=torch.float32, device=dev)
    y, g, vecs = _bn_inputs(gen, (2, 9, 16, 64), torch.bfloat16, dev)
    eager = (warp_nearest(labels, theta, (72, 128), values, (36, 64)), *bn_relu_bwd(y, g, *vecs))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # warm-up off the default stream, as capture wants
        warp_nearest(labels, theta, (72, 128), values, (36, 64))
        bn_relu_bwd(y, g, *vecs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = (warp_nearest(labels, theta, (72, 128), values, (36, 64)), *bn_relu_bwd(y, g, *vecs))
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, eager))


def test_k1_k7bwd_route_counters(dev):
    """A vector-route call counts in ``vec_launches`` and ``launches``; a
    scalar-route call only in ``launches``; refused calls in neither."""
    from sports_field_homography_tpu_torch.ops.bn_relu_bwd import bn_relu_bwd

    gen = torch.Generator(device=dev).manual_seed(45)
    labels = torch.randint(0, 4, (36, 64), generator=gen, device=dev, dtype=torch.uint8)
    theta = torch.eye(3, device=dev)[None]
    values = torch.arange(256, dtype=torch.float32, device=dev)
    _vec_routed(warp_nearest, True, lambda: warp_nearest(labels, theta, (36, 64), values))
    _vec_routed(warp_nearest, False, lambda: warp_nearest(labels, theta, (36, 62), values))
    y, g, vecs = _bn_inputs(gen, (1, 4, 4, 16), torch.bfloat16, dev)
    _vec_routed(bn_relu_bwd, True, lambda: bn_relu_bwd(y, g, *vecs))
    _vec_routed(bn_relu_bwd, False, lambda: bn_relu_bwd(y[..., :12], g[..., :12],
                                                        *(v[:12] for v in vecs)))
    counts = (warp_nearest.launches, warp_nearest.vec_launches, bn_relu_bwd.launches,
              bn_relu_bwd.vec_launches)
    with pytest.raises(TypeError):
        warp_nearest(labels.float(), theta, (36, 64), values)
    with pytest.raises(ValueError, match="different devices"):
        bn_relu_bwd(y, g, vecs[0].cpu(), *vecs[1:])
    assert counts == (warp_nearest.launches, warp_nearest.vec_launches, bn_relu_bwd.launches,
                      bn_relu_bwd.vec_launches)


def _full_output_bundle(dev, warp, dtype=torch.float32):
    """A seeded resnet18 model at 64x36 on the card, BN folded, with the
    NCAA court at ``warp`` (W, H), as the predict CLI's engine holds it."""
    import os

    from sports_field_homography_tpu_torch.cli.engine import ModelBundle
    from sports_field_homography_tpu_torch.data.assets import open_court_template
    from sports_field_homography_tpu_torch.geometry.court import load_court_poi
    from sports_field_homography_tpu_torch.models import Reconstructor, ReconstructorConfig
    from sports_field_homography_tpu_torch.models.layers import init_weights
    from sports_field_homography_tpu_torch.ops.fold_bn import fold_batchnorm
    from sports_field_homography_tpu_torch.ops.warp import template_value_table

    assets = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
    cfg = ReconstructorConfig(target_size=(64, 36), unet_size=(64, 36), warp_size=warp,
                              resnet_name="resnet18")
    model = Reconstructor(cfg, dtype=dtype)
    gen = torch.Generator().manual_seed(46)
    init_weights(model, gen)
    with torch.no_grad():
        model.resnet_reg.reg.weight.copy_(
            torch.randn(model.resnet_reg.reg.weight.shape, generator=gen) * 5e-3)
    model = fold_batchnorm(model).to(dev).eval()
    labels = open_court_template(os.path.join(assets, "mask_ncaa_v4_nc4_m_onehot.png"), 4,
                                 size=warp)
    poi = load_court_poi(os.path.join(assets, "template_ncaa_v4_points.json"))
    return ModelBundle(model, torch.from_numpy(labels).to(dev),
                       template_value_table(labels, 4).to(dev), poi.astype(np.float32), cfg, dev)


@pytest.mark.parametrize("warp", [(128, 72), (100, 56)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_output_program_runs_k1_once_on_the_full_grid(dev, warp, dtype):
    """With warp_mask kept, K1 runs once a batch on the full warp grid (no
    sampled launch), and theta and the score equal the theta+consistency
    program's bit for bit, whose one K1 launch is on the sampled grid."""
    from sports_field_homography_tpu_torch.cli.engine import predict_fn
    from sports_field_homography_tpu_torch.models import reconstructor

    bundle = _full_output_bundle(dev, warp, dtype)
    frames = torch.randint(0, 256, (3, 36, 64, 3), generator=torch.Generator(device=dev)
                           .manual_seed(47), device=dev, dtype=torch.uint8)
    grids, k1 = [], reconstructor.warp_nearest

    def recording(labels, theta, out_hw, values, sample_hw=None):
        grids.append((tuple(out_hw), sample_hw))
        return k1(labels, theta, out_hw, values, sample_hw)

    reconstructor.warp_nearest = recording
    try:
        with torch.inference_mode():
            n0 = warp_nearest.launches
            slim = predict_fn(bundle, True, ["theta", "consist_score"])(frames)
            n1 = warp_nearest.launches
            full = predict_fn(bundle, True, ["theta", "consist_score", "warp_mask", "poi",
                                             "segm_mask"])(frames)
            n2 = warp_nearest.launches
    finally:
        reconstructor.warp_nearest = k1
    hw = (warp[1], warp[0])
    assert grids == [(hw, (36, 64)), (hw, None)] and (n1 - n0, n2 - n1) == (1, 1)
    assert set(slim) == {"theta", "consist_score"}
    assert set(full) == {"theta", "consist_score", "warp_mask", "poi", "segm_mask"}
    assert torch.equal(full["theta"], slim["theta"])
    assert torch.equal(full["consist_score"], slim["consist_score"])
    assert full["warp_mask"].shape == (3,) + hw and full["poi"].shape[0] == 3
    assert torch.isfinite(full["poi"]).all()


@pytest.mark.parametrize("out_hw,sample_hw", [((720, 1280), (360, 640)), ((72, 128), (36, 64)),
                                              ((56, 100), (36, 64)), ((360, 640), (37, 65)),
                                              ((36, 64), (36, 64))])
def test_downsampled_full_grid_labels_equal_sampled_labels(dev, out_hw, sample_hw):
    """The nearest downsample of K1's full-grid labels (the consistency
    labels when warp_mask is kept) equals K1 on the sampled grid bit for
    bit, on the vector and the scalar store routes."""
    from sports_field_homography_tpu_torch.ops.resize import resize_nearest

    gen = torch.Generator(device=dev).manual_seed(48)
    labels = torch.randint(0, 4, (720, 1280), generator=gen, device=dev, dtype=torch.uint8)
    theta = torch.eye(3, device=dev).repeat(4, 1, 1) + _rand(gen, (4, 3, 3), dev, 0.05)
    values = torch.arange(256, dtype=torch.float32, device=dev) * 0.25
    full = warp_nearest(labels, theta, out_hw, values) * 4
    sampled = warp_nearest(labels, theta, out_hw, values, sample_hw) * 4
    down = resize_nearest(full, sample_hw)
    assert down.device.type == "cuda" and torch.equal(down, sampled)
    assert torch.equal(resize_nearest(full.cpu(), sample_hw), sampled.cpu())


def test_full_output_program_narrows_to_uint8_on_the_card(dev):
    """segm_mask is the uint8 argmax of the logits and warp_mask the uint8
    labels, both made on the card: what the CLI copies to the host."""
    from sports_field_homography_tpu_torch.cli.engine import predict_fn

    bundle = _full_output_bundle(dev, (128, 72), torch.bfloat16)
    frames = torch.randint(0, 256, (2, 36, 64, 3), generator=torch.Generator(device=dev)
                           .manual_seed(49), device=dev, dtype=torch.uint8)
    with torch.inference_mode():
        got = predict_fn(bundle, False, ["segm_mask", "warp_mask"])(frames)
        ref = bundle.model.predict(frames.float() / 255.0, bundle.court_labels,
                                   bundle.value_table, consistency=False, warp_mask=True)
    assert set(got) == {"segm_mask", "warp_mask"}
    for k in got:
        assert got[k].dtype == torch.uint8 and got[k].device.type == "cuda"
    assert torch.equal(got["segm_mask"], ref["logits"].argmax(-1).to(torch.uint8))
    assert torch.equal(got["warp_mask"], ref["warp_mask"].to(torch.uint8))
    assert torch.equal(got["warp_mask"].float(), ref["warp_mask"])   # whole labels


def test_device_prefetch_leaves_orig_img_on_the_host(dev):
    from sports_field_homography_tpu_torch.data.loader import device_prefetch

    batches = [{"image": np.full((2, 4, 5, 3), i, np.uint8), "name": ["a", "b"],
                "orig_img": np.full((2, 8, 10, 3), i, np.uint8)} for i in range(3)]
    out = list(device_prefetch(iter(batches), dev))
    for i, b in enumerate(out):
        assert b["image"].device.type == "cuda" and int(b["image"][0, 0, 0, 0]) == i
        assert isinstance(b["orig_img"], np.ndarray) and b["orig_img"][0, 0, 0, 0] == i


@pytest.mark.parametrize("unet_bilinear,resnet,n_bn", [(False, "resnet34", 36),
                                                       (True, "resnet50", 53)])
def test_folded_stn_bn_add_bit_equal_at_batch_32(dev, unet_bilinear, resnet, n_bn):
    """The benchmark's two predict models (deconv UNet + ResNet34, bilinear
    UNet + ResNet-50; 640x360, bf16, BN folded, a 1280x720 warp grid) at
    batch 32: every STN BN takes the one-pass add (``bn_eval.folded``), and
    theta, the score and K1's labels equal those of the same model with the
    fold's mark cleared (the whole eval formula), bit for bit."""
    import copy
    import os

    from torch import nn

    from sports_field_homography_tpu_torch.data.assets import open_court_template
    from sports_field_homography_tpu_torch.models import Reconstructor, ReconstructorConfig
    from sports_field_homography_tpu_torch.models.layers import bn_eval, init_weights
    from sports_field_homography_tpu_torch.ops.fold_bn import fold_batchnorm
    from sports_field_homography_tpu_torch.ops.warp import template_value_table

    cfg = ReconstructorConfig(target_size=(640, 360), unet_size=(640, 360),
                              warp_size=(1280, 720), unet_bilinear=unet_bilinear,
                              resnet_name=resnet, resnet_input="img+mask")
    model = Reconstructor(cfg, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(48)
    init_weights(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.weight.copy_(torch.rand(m.weight.shape, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
        reg = model.resnet_reg.reg.weight
        reg.copy_(torch.randn(reg.shape, generator=gen) * 1e-4)
    model = fold_batchnorm(model).to(dev).eval()
    full = copy.deepcopy(model)
    for m in full.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.folded = False
    assets = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
    labels = torch.from_numpy(open_court_template(
        os.path.join(assets, "mask_ncaa_v4_nc4_m_onehot.png"), 4, size=(1280, 720))).to(dev)
    values = template_value_table(labels.cpu().numpy(), 4).to(dev)
    x = torch.rand((32, 360, 640, 3), generator=torch.Generator(device=dev).manual_seed(49),
                   device=dev)
    with torch.inference_mode():
        f0, n0 = bn_eval.folded, bn_eval.full
        got = model.predict(x, labels, values, consistency=True, warp_mask=True)
        counts = (bn_eval.folded - f0, bn_eval.full - n0)
        want = full.predict(x, labels, values, consistency=True, warp_mask=True)
    assert counts == (n_bn, 0)
    assert (got["theta"] - torch.eye(3, device=dev)).abs().max() > 1e-4
    for key in ("theta", "consist_score", "warp_mask", "logits"):
        assert torch.equal(got[key], want[key]), key
