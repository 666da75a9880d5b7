"""The CUDA kernels against their plain versions on a GPU, at edge shapes
the main paths do not reach (ragged tiles, shallow or odd channel counts,
1x1 images, odd sizes, degenerate homographies, strided inputs, side
streams), and the bitwise repeatability of the training kernels'
reductions (f32 reductions against the plain version in float64, rel-L2
1e-5; bf16 against the plain version on the same inputs, 1e-3).

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
    got = warp_nearest(labels, theta, out_hw, sample_hw, value_step=0.25)
    ref = warp_nearest_plain(labels, theta, out_hw, sample_hw, value_step=0.25)
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
