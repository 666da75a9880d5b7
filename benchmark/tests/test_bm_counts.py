"""The yardstick's counts against hand counts."""
import json

import pytest
import torch
from torch import nn

import counts
from conftest import BENCH
from reference.model import Bottleneck

PEAK_BF16, HBM = 989e12, 3.35e12


def test_k2_conv_64_at_360x640_batch8_matches_the_hand_count():
    # 2 * 8 * 360 * 640 * 64 * 64 * 9 FLOPs; bf16 input, output and weights once
    with torch.device("meta"):
        conv, x = nn.Conv2d(64, 64, 3, padding=1), torch.empty(1, 64, 360, 640)
    layer, = counts.module_layers(conv, lambda name, m: "conv3x3", lambda: conv(x))
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


# each kind's multiply-adds, input, output and weight elements for one frame,
# and its number of layers, as the counts written out by hand read them
KIND_TOTALS = {
    "flagship": {
        "conv3x3": (161092730880, 118394880, 97648640, 28237824, 17),
        "deconv2x2": (7507804160, 13803520, 27607040, 2785280, 4),
        "head": (58982400, 14745600, 921600, 256, 1),
        "stem": (398131200, 691200, 14745600, 1728, 1),
        "stn_conv": (17876500480, 16808960, 17285120, 21280192, 36),
        "stn_linear": (4608, 512, 9, 4608, 1)},
    "bilinear-r50": {
        "conv3x3": (140047810560, 117944320, 90296320, 17252352, 17),
        "head": (58982400, 14745600, 921600, 256, 1),
        "stem": (398131200, 691200, 14745600, 1728, 1),
        "stn_conv": (19855687680, 50191360, 51404800, 23467456, 53),
        "stn_linear": (18432, 2048, 9, 18432, 1)},
}
# (forward FLOPs a frame; conv3x3_work at predict's batch 32; at train's 26;
# wgrad3x3_work at 26), bf16
WORK = {
    "flagship": (373868307456, (10309934776320, 13883260928),
                 (16753644011520, 22581477376), (8376822005760, 11347214336)),
    "bilinear-r50": (320721260544, (8963059875840, 13361905664),
                     (14564972298240, 21726035968), (7282486149120, 10897522688)),
}


@pytest.mark.parametrize("config", ["flagship", "bilinear-r50"])
def test_each_kind_counts_as_the_hand_written_counts_did(config):
    model = json.loads((BENCH / "configs" / f"{config}.json").read_text())["model"]
    totals = {}
    for la in counts.model_layers(model):
        t = totals.setdefault(la.kind, [0, 0, 0, 0, 0])
        for i, v in enumerate((la.macs, la.inputs, la.outputs, la.weights, 1)):
            t[i] += v
    assert {k: tuple(v) for k, v in totals.items()} == KIND_TOTALS[config]
    fwd, c3_predict, c3_train, wgrad = WORK[config]
    assert counts.forward_flops(model) == fwd
    assert counts.conv3x3_work(model, 32, 2, train=False) == c3_predict
    assert counts.conv3x3_work(model, 26, 2, train=True) == c3_train
    assert counts.wgrad3x3_work(model, 26, 2) == wgrad


def test_a_grouped_bottleneck_matches_the_hand_count():
    """ResNeXt-101 32x8d's first block of layer3: 512 -> width 512 in 32
    groups, stride 2 on the 3x3, out 1024, at 45x80 in."""
    with torch.device("meta"):
        ds = nn.Sequential(nn.Conv2d(512, 1024, 1, 2, bias=False), nn.BatchNorm2d(1024))
        block = Bottleneck(512, 256, 2, ds, groups=32, base_width=8)
        x = torch.empty(1, 512, 45, 80)
    layers = {la.name: la for la in counts.module_layers(block, lambda n, m: "stn_conv",
                                                        lambda: block(x))}
    hw, howo = 45 * 80, 23 * 40
    width = 256 * 8 // 64 * 32
    assert width == 1024
    assert layers["conv1"].macs == hw * width * 512
    assert layers["conv2"].macs == howo * width * (width // 32) * 9
    assert layers["conv2"].weights == width * (width // 32) * 9
    assert (layers["conv2"].inputs, layers["conv2"].outputs) == (hw * width, howo * width)
    assert layers["conv3"].macs == howo * 1024 * width
    assert layers["downsample.0"].macs == howo * 1024 * 512


def _hand_stn_macs(h, w, cin, blocks, groups, width_per_group):
    """A Bottleneck STN's multiply-adds written out block by block."""
    def out(n, k, s, p):
        return (n + 2 * p - k) // s + 1
    h, w = out(h, 7, 2, 3), out(w, 7, 2, 3)
    macs = h * w * cin * 64 * 49
    h, w = out(h, 3, 2, 1), out(w, 3, 2, 1)
    inplanes = 64
    for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), blocks)):
        width = planes * width_per_group // 64 * groups
        for b in range(n):
            s = 2 if b == 0 and stage > 0 else 1
            ho, wo = out(h, 3, s, 1), out(w, 3, s, 1)
            macs += h * w * inplanes * width + ho * wo * width * (width // groups) * 9
            macs += ho * wo * width * planes * 4
            if b == 0:
                macs += ho * wo * inplanes * planes * 4
            inplanes, h, w = planes * 4, ho, wo
    return macs + inplanes * 9


@pytest.mark.parametrize("resnet,blocks,groups,width,gflop", [
    ("resnet152", (3, 8, 36, 3), 1, 64, 109.23),
    ("resnext50_32x4d", (3, 4, 6, 3), 32, 4, 40.99),
    ("resnext101_32x8d", (3, 4, 23, 3), 32, 8, 155.2),
    ("wide_resnet50_2", (3, 4, 6, 3), 1, 128, 108.19),
    ("wide_resnet101_2", (3, 4, 23, 3), 1, 128, 214.79),
])
def test_every_bottleneck_stn_matches_the_hand_count(resnet, blocks, groups, width, gflop):
    model = json.loads((BENCH / "configs" / "flagship.json").read_text())["model"]
    model = dict(model, resnet_name=resnet)
    stn = sum(la.macs for la in counts.model_layers(model) if la.kind.startswith("stn"))
    assert stn == _hand_stn_macs(360, 640, 7, blocks, groups, width)
    assert 2 * stn / 1e9 == pytest.approx(gflop, abs=0.1)
