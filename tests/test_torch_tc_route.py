"""K2's, K5's, K3's and K3-bwd's routes between the tensor-core kernels and
the SIMT kernels (CPU).

* The route gate: every (Cin, Cin2, Cout, H, W) that the deconv and the
  bilinear UNet give K2 and K5 at 640x360, in predict and in a train step
  (forward with stats, dgrad, wgrad), and every (Cin, Cout, H, W) they
  give K3 and K3-bwd, recorded from the modules of ``models/unet.py``
  themselves, takes the tensor-core route in bf16 and the SIMT route in
  f32.
* The tensor-core kernels' K-major weight packs: round trips; K2's is the
  transpose of the SIMT kernel's row-major weight matrix, K3's two are
  JAX's ``deconv_pallas._parity_weights`` and its transpose.
* The tensor-core wgrads' pixel splits: 64-pixel steps that cover every
  pixel once.
"""
import numpy as np
import pytest
import torch
from torch import nn

from sports_field_homography_tpu.ops import deconv_pallas
from sports_field_homography_tpu_torch.models.unet import unet_forward, unet_layers
from sports_field_homography_tpu_torch.ops import conv3x3 as conv_mod
from sports_field_homography_tpu_torch.ops import deconv as deconv_mod
from sports_field_homography_tpu_torch.ops import double_conv
from sports_field_homography_tpu_torch.ops import wgrad3x3 as wgrad_mod
from sports_field_homography_tpu_torch.ops.conv3x3 import dgrad_weights, pack_weights
from sports_field_homography_tpu_torch.ops.reduce import split_reduction

# the deconv UNet's four up-convs at 640x360: (Cin, Cout, H, W) of the input
UP_CONVS = {(1024, 512, 22, 40), (512, 256, 45, 80), (256, 128, 90, 160), (128, 64, 180, 320)}

FRAME_HW = (360, 640)


def _unet_kernel_shapes(bilinear, monkeypatch):
    """Run the UNet's predict and train paths at 640x360 (batch 1, f32, on
    the CPU) with K2, K5, K3 and K3-bwd replaced by stubs that record their
    shapes and return zeros; returns ({(Cin, Cin2, Cout, H, W)}, {(Cin,
    Cout, H, W)}, {"fwd": [(Cin, Cout, H, W)], "bwd": [...]}) -- K3's shapes
    as lists, one entry per launch."""
    convs, wgrads, deconvs = [], [], {"fwd": [], "bwd": []}

    def conv_stub(x, w, bias=None, prologue=None, stats=False, x2=None, w2=None):
        cin2 = 0 if x2 is None else x2.shape[-1]
        convs.append((x.shape[-1], cin2, w.shape[-1], x.shape[1], x.shape[2]))
        y = torch.zeros(tuple(x.shape[:3]) + (w.shape[-1],), dtype=x.dtype)
        return (y, torch.zeros(2, w.shape[-1])) if stats else y

    def wgrad_stub(x, dy, prologue=None):
        wgrads.append((x.shape[-1], dy.shape[-1], x.shape[1], x.shape[2]))
        return (torch.zeros(3, 3, x.shape[-1], dy.shape[-1]),
                torch.zeros(dy.shape[-1]))

    def deconv_stub(x, w, bias):
        deconvs["fwd"].append((x.shape[-1], w.shape[-1], x.shape[1], x.shape[2]))
        return torch.zeros((x.shape[0], 2 * x.shape[1], 2 * x.shape[2], w.shape[-1]),
                           dtype=x.dtype)

    def deconv_bwd_stub(x, dy, w):
        assert tuple(dy.shape[1:3]) == (2 * x.shape[1], 2 * x.shape[2])
        deconvs["bwd"].append((x.shape[-1], w.shape[-1], x.shape[1], x.shape[2]))
        return torch.zeros_like(x), torch.zeros(w.shape), torch.zeros(w.shape[-1])

    monkeypatch.setattr(double_conv, "conv3x3", conv_stub)
    monkeypatch.setattr(double_conv, "wgrad3x3", wgrad_stub)
    monkeypatch.setattr(deconv_mod, "_forward", deconv_stub)
    monkeypatch.setattr(deconv_mod, "deconv2x2_backward", deconv_bwd_stub)
    holder = nn.Module()
    for name, layer in unet_layers(bilinear=bilinear).items():
        setattr(holder, name, layer)
    x = torch.rand((1,) + FRAME_HW + (3,))
    holder.eval()
    with torch.no_grad():
        unet_forward(holder, x)
    n_predict = len(convs)
    holder.train()
    logits, _, _ = unet_forward(holder, x)
    logits.float().sum().backward()
    # 17 K2 launches to predict; a train step adds 17 with stats, the
    # dgrads and 21 K5 launches (4 of them the decoder's second inputs)
    assert n_predict == 17 and len(convs) > 2 * n_predict and len(wgrads) == 21
    return set(convs), set(wgrads), deconvs


@pytest.mark.parametrize("bilinear", [False, True], ids=["deconv", "bilinear"])
def test_unet_shapes_take_the_tensor_core_route_in_bf16(bilinear, monkeypatch):
    convs, wgrads, _ = _unet_kernel_shapes(bilinear, monkeypatch)
    levels = {(h, w) for *_, h, w in convs}
    assert levels == {(360, 640), (180, 320), (90, 160), (45, 80), (22, 40)}
    assert any(cin2 for _, cin2, *_ in convs)                  # the decoder's two-input convs
    assert any(cin > cout for cin, _, cout, *_ in convs)       # a dgrad (or a narrowing conv)
    for cin, cin2, cout, h, w in convs:
        assert conv_mod.tensor_core_route(torch.bfloat16, cin, cin2, cout), (cin, cin2, cout, h, w)
        assert not conv_mod.tensor_core_route(torch.float32, cin, cin2, cout)
    for cin, cout, h, w in wgrads:
        assert wgrad_mod.tensor_core_route(torch.bfloat16, cin, cout), (cin, cout, h, w)
        assert not wgrad_mod.tensor_core_route(torch.float32, cin, cout)


@pytest.mark.parametrize("bilinear", [False, True], ids=["deconv", "bilinear"])
def test_unet_up_convs_take_the_tensor_core_route_in_bf16(bilinear, monkeypatch):
    """The deconv UNet gives K3 exactly its four up-convs, once each in
    predict and once each in a train step, and K3-bwd the same four; the
    bilinear UNet gives neither kernel anything."""
    _, _, deconvs = _unet_kernel_shapes(bilinear, monkeypatch)
    if bilinear:
        assert deconvs == {"fwd": [], "bwd": []}
        return
    assert len(deconvs["fwd"]) == 8 and set(deconvs["fwd"]) == UP_CONVS
    assert len(deconvs["bwd"]) == 4 and set(deconvs["bwd"]) == UP_CONVS
    for cin, cout, h, w in UP_CONVS:
        assert deconv_mod.tensor_core_route(torch.bfloat16, cin, cout), (cin, cout, h, w)
        assert not deconv_mod.tensor_core_route(torch.float32, cin, cout)


@pytest.mark.parametrize("cin,cout", [(24, 10), (64, 32), (8, 3), (96, 64), (64, 0)])
def test_deconv_edge_shapes_take_the_simt_route(cin, cout):
    """The K3 edge tests' channel counts stay on the SIMT kernels in bf16."""
    assert not deconv_mod.tensor_core_route(torch.bfloat16, cin, cout)


@pytest.mark.parametrize("cin,cin2,cout", [(3, 0, 5), (48, 0, 96), (64, 0, 130),
                                           (48, 80, 96), (16, 8, 33), (64, 32, 64)])
def test_edge_shapes_take_the_simt_route(cin, cin2, cout):
    """The edge tests' channel counts stay on the SIMT kernels in bf16."""
    assert not conv_mod.tensor_core_route(torch.bfloat16, cin, cin2, cout)
    assert not wgrad_mod.tensor_core_route(torch.bfloat16, cin + cin2, cout)


@pytest.mark.parametrize("cin,cout", [(64, 64), (128, 64), (64, 192), (1024, 512)])
def test_pack_weights_round_trip(cin, cout):
    gen = torch.Generator().manual_seed(cin + cout)
    w = torch.randn((3, 3, cin, cout), generator=gen)
    packed = pack_weights(w)
    assert packed.shape == (cout, 9 * cin) and packed.is_contiguous()
    torch.testing.assert_close(packed.reshape(cout, 3, 3, cin).permute(1, 2, 3, 0), w,
                               rtol=0, atol=0)
    torch.testing.assert_close(packed.t(), w.reshape(9 * cin, cout), rtol=0, atol=0)
    for ky, kx, ci, co in ((0, 0, 0, 0), (2, 1, cin - 1, cout - 1), (1, 2, cin // 2, 3)):
        assert packed[co, (ky * 3 + kx) * cin + ci] == w[ky, kx, ci, co]
    dg = pack_weights(dgrad_weights(w))      # the dgrad's weights: (Cin, 9*Cout)
    assert dg.shape == (cin, 9 * cout)
    assert dg[5, 0] == w[2, 2, 5, 0]         # tap (0, 0) of the flip is tap (2, 2)


@pytest.mark.parametrize("m,cin,cout", [(8 * 360 * 640, 64, 64), (8 * 180 * 320, 128, 128),
                                        (8 * 22 * 40, 1024, 1024), (65, 64, 64), (1, 64, 64)])
def test_tensor_core_wgrad_split_covers_the_pixels(m, cin, cout):
    chunk, splits = split_reduction(m, 9 * cin, cout, stage=64,
                                    tile_cols=128 if cout % 128 == 0 else 64)
    assert chunk % 64 == 0 and chunk > 0
    assert (splits - 1) * chunk < m <= splits * chunk


@pytest.mark.parametrize("cin,cout", [(64, 64), (128, 64), (64, 192), (1024, 512)])
def test_deconv_weight_packs(cin, cout):
    """K3's two K-major packs -- (Cin, 4*Cout), the dgrad's B, and (4*Cout,
    Cin), the forward's B -- round-trip to the (Cin, 2, 2, Cout) weight and
    order their columns as JAX's ``_parity_weights``: (p*2 + q)*Cout + o."""
    w_np = np.random.default_rng(cin + cout).standard_normal((cin, 2, 2, cout)).astype(np.float32)
    w = torch.from_numpy(w_np)
    wk, wkt = deconv_mod.pack_weights(w), deconv_mod.pack_weights_t(w)
    assert wk.shape == (cin, 4 * cout) and wkt.shape == (4 * cout, cin)
    assert wk.is_contiguous() and wkt.is_contiguous()
    torch.testing.assert_close(wk.reshape(cin, 2, 2, cout), w, rtol=0, atol=0)
    torch.testing.assert_close(wkt.t().reshape(cin, 2, 2, cout), w, rtol=0, atol=0)
    jax_pack = np.asarray(deconv_pallas._parity_weights(w_np))
    np.testing.assert_array_equal(wk.numpy(), jax_pack)
    np.testing.assert_array_equal(wkt.numpy(), jax_pack.T)
    for c, p, q, o in ((0, 0, 0, 0), (cin - 1, 1, 1, cout - 1), (cin // 2, 1, 0, 3)):
        assert wk[c, (p * 2 + q) * cout + o] == w[c, p, q, o]
        assert wkt[(p * 2 + q) * cout + o, c] == w[c, p, q, o]


@pytest.mark.parametrize("m,cin,cout", [(8 * 22 * 40, 1024, 512), (8 * 45 * 80, 512, 256),
                                        (8 * 90 * 160, 256, 128), (8 * 180 * 320, 128, 64),
                                        (1, 64, 64), (65, 128, 64)])
def test_tensor_core_deconv_wgrad_split_covers_the_pixels(m, cin, cout):
    """K3-bwd's tensor-core wgrad split: 64-aligned chunks, every pixel in
    exactly one split, within the partials' cap."""
    chunk, splits = deconv_mod.tc_wgrad_split(m, cin, cout)
    assert chunk % 64 == 0 and chunk > 0
    assert (splits - 1) * chunk < m <= splits * chunk
    covered = np.zeros(m, np.int64)
    for z in range(splits):
        covered[z * chunk:min((z + 1) * chunk, m)] += 1
    assert (covered == 1).all()
    assert splits * cin * 4 * cout * 4 <= 256 << 20
