"""The yardstick's counts against hand counts."""
import json

import pytest

import counts
from conftest import BENCH

PEAK_BF16, HBM = 989e12, 3.35e12


def test_k2_conv_64_at_360x640_batch8_matches_the_hand_count():
    # 2 * 8 * 360 * 640 * 64 * 64 * 9 FLOPs; bf16 input, output and weights once
    layer = counts._conv("c", "conv3x3", 360, 640, 64, 64, 3, 1, 1)[0]
    flops, nbytes = counts.layer_work(layer, 8, 2, 2)
    assert flops == 2 * 8 * 360 * 640 * 64 * 64 * 9 == 135_895_449_600
    assert nbytes == 2 * (2 * 8 * 360 * 640 * 64) + 2 * 64 * 64 * 9 == 471_932_928
    bound = counts.bound_seconds(flops, nbytes, PEAK_BF16, HBM)
    assert bound == pytest.approx(0.141e-3, rel=2e-3)          # bytes bound it
    assert nbytes / HBM > flops / PEAK_BF16


def _hand_unet_macs(h, w, bilinear):
    """The UNet's multiply-adds written out layer by layer."""
    f = 2 if bilinear else 1
    s = [(h, w), (h // 2, w // 2), (h // 4, w // 4), (h // 8, w // 8), (h // 16, w // 16)]
    px = [a * b for a, b in s]
    c3 = 9
    m = px[0] * (3 * 64 + 64 * 64) * c3                              # inc
    m += px[1] * (64 * 128 + 128 * 128) * c3                         # down1
    m += px[2] * (128 * 256 + 256 * 256) * c3                        # down2
    m += px[3] * (256 * 512 + 512 * 512) * c3                        # down3
    m += px[4] * (512 * 1024 // f + (1024 // f) ** 2) * c3           # down4
    if bilinear:   # DoubleConv(in, out, in // 2) at the skip's size
        m += px[3] * (1024 * 512 + 512 * 256) * c3
        m += px[2] * (512 * 256 + 256 * 128) * c3
        m += px[1] * (256 * 128 + 128 * 64) * c3
        m += px[0] * (128 * 64 + 64 * 64) * c3
    else:          # k2s2 up-conv (in -> in/2 at 4x the pixels), then DoubleConv(in, out)
        m += 4 * px[4] * 1024 * 512 + px[3] * (1024 * 512 + 512 * 512) * c3
        m += 4 * px[3] * 512 * 256 + px[2] * (512 * 256 + 256 * 256) * c3
        m += 4 * px[2] * 256 * 128 + px[1] * (256 * 128 + 128 * 128) * c3
        m += 4 * px[1] * 128 * 64 + px[0] * (128 * 64 + 64 * 64) * c3
    return m + px[0] * 64 * 4                                        # 1x1 head


@pytest.mark.parametrize("config,unet_gflop,stn_gflop,total_gflop", [
    ("flagship", 338.1, 35.75, 373.9),
    ("bilinear-r50", 281.0, 39.71, 320.7),
])
def test_per_frame_totals(config, unet_gflop, stn_gflop, total_gflop):
    model = json.loads((BENCH / "configs" / f"{config}.json").read_text())["model"]
    layers = counts.model_layers(model)
    unet = 2 * sum(la.macs for la in layers if not la.kind.startswith("stn"))
    stn = 2 * sum(la.macs for la in layers if la.kind.startswith("stn"))
    assert unet == 2 * _hand_unet_macs(360, 640, model["unet_bilinear"])
    assert unet / 1e9 == pytest.approx(unet_gflop, abs=0.05)
    assert stn / 1e9 == pytest.approx(stn_gflop, abs=0.01)
    assert counts.forward_flops(model) == unet + stn
    assert counts.forward_flops(model) / 1e9 == pytest.approx(total_gflop, abs=0.1)
    # the UNet's 3x3 convs after the stem are K2's: 17 of them
    assert sum(la.kind == "conv3x3" for la in layers) == 17


def test_wgrad_work_reads_both_activations_and_writes_f32_weights():
    model = json.loads((BENCH / "configs" / "flagship.json").read_text())["model"]
    f_fwd, b_fwd = counts.conv3x3_work(model, 26, 2, train=False)
    f_tr, b_tr = counts.conv3x3_work(model, 26, 2, train=True)
    f_w, b_w = counts.wgrad3x3_work(model, 26, 2)
    assert f_tr == 2 * f_fwd and b_tr == 2 * b_fwd and f_w == f_fwd
    weights = sum(la.weights for la in counts.model_layers(model) if la.kind == "conv3x3")
    assert b_w == b_fwd - 2 * weights + 4 * weights
