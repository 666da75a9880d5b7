"""The CUDA kernels against their plain versions on a GPU, at edge shapes
the predict path does not reach (ragged tiles, shallow or odd channel
counts, odd sizes, degenerate homographies, strided inputs, side streams).

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
