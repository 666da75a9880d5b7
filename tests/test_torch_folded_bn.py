"""The ResNet STN's folded BatchNorm (CPU).

``ops/fold_bn.fold_pair`` marks each BN it folds (``bn.folded``), and in
eval mode ``models/layers.bn_apply`` applies a marked BN as one in-place
add of its f32 additive term on the conv's output.  With the folded
constants (scale 1, mean 0, ``var + eps`` 1) the whole f32 formula of
``bn_eval`` computes the same numbers, so theta and every block's output
equal those of the same folded model with the mark cleared, bit for bit,
in bf16 and in f32.  ``bn_eval.folded`` and ``bn_eval.full`` count the eval
BNs applied each way; train mode counts in neither.  The UNet's path does
not read the mark: a folded Reconstructor's logits are unchanged by it.
"""
import copy

import numpy as np
import pytest
import torch
from torch import nn

from sports_field_homography_tpu_torch.models import Reconstructor, ReconstructorConfig
from sports_field_homography_tpu_torch.models.layers import bn_eval, init_weights, nchw
from sports_field_homography_tpu_torch.models.resnet import ResNetSTN, resnet_models
from sports_field_homography_tpu_torch.ops.fold_bn import fold_batchnorm

W, H, B, CIN = 64, 36, 2, 7
N_BN = {"resnet18": 20, "resnet34": 36, "resnet50": 53}


@torch.no_grad()
def _seeded(model: nn.Module, seed: int) -> nn.Module:
    """Seeded weights with non-trivial BN statistics and a nonzero head."""
    gen = torch.Generator().manual_seed(seed)
    init_weights(model, gen)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.weight.copy_(torch.rand(m.weight.shape, generator=gen) + 0.5)
            m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.1)
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
    for m in model.modules():
        if isinstance(m, ResNetSTN):
            m.reg.weight.copy_(torch.randn(m.reg.weight.shape, generator=gen) * 1e-3)
    return model


def _stn(name: str, seed: int = 0) -> ResNetSTN:
    return _seeded(ResNetSTN(in_channels=CIN, **resnet_models[name]), seed)


def _unmarked(model: nn.Module) -> nn.Module:
    """A copy of a folded model whose BNs take the whole eval formula."""
    full = copy.deepcopy(model)
    for m in full.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.folded = False
    return full


def _counts(fn):
    f0, n0 = bn_eval.folded, bn_eval.full
    out = fn()
    return out, (bn_eval.folded - f0, bn_eval.full - n0)


def _frames(shape, dtype, seed=1):
    x = torch.from_numpy(np.random.default_rng(seed).random(shape, dtype=np.float32))
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["resnet18", "resnet34", "resnet50"])
def test_folded_bn_add_equals_the_full_formula(name, dtype):
    """Theta, and the output of layer2's first block (with its downsample),
    equal the whole f32 formula's on the same folded constants, bit for
    bit; in f32 the folded model's theta is the unfolded one's within
    rounding."""
    model = _stn(name).eval()
    x = _frames((B, H, W, CIN), dtype)
    with torch.no_grad():
        unfolded = model(x)
        fold_batchnorm(model)
        full = _unmarked(model)
        got, want = model(x), full(x)
        assert got.dtype == torch.float32
        assert torch.equal(got, want)
        assert (got - torch.eye(3)).abs().max() > 1e-4      # the backbone reaches theta
        if dtype == torch.float32:
            torch.testing.assert_close(got, unfolded, rtol=1e-5, atol=1e-5)

        block = model.layer2[0]
        assert block.downsample is not None
        c = block.conv1.in_channels
        h = nchw(_frames((B, H // 4, W // 4, c), dtype, seed=2) - 0.5)
        got, want = block(h.clone()), full.layer2[0](h.clone())
        assert got.dtype == dtype
        assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["folded", "unfolded", "train"])
@pytest.mark.parametrize("name", ["resnet34", "resnet50"])
def test_bn_eval_counters(name, mode):
    """A folded eval forward applies every BN as the one-pass add, an
    unfolded one every BN through the whole formula; train mode neither."""
    model = _stn(name)
    if mode == "folded":
        fold_batchnorm(model)
    model.train(mode == "train")
    x = _frames((B, H, W, CIN), torch.float32)
    with torch.no_grad():
        _, counts = _counts(lambda: model(x))
    n = N_BN[name]
    assert counts == {"folded": (n, 0), "unfolded": (0, n), "train": (0, 0)}[mode]


@pytest.mark.parametrize("move", ["deepcopy", "to_device", "to_channels_last",
                                  "reconstructor"])
def test_folded_mark_survives_moves(move):
    """The mark is set on every BN that fold_batchnorm folds (the
    Reconstructor's UNet too) and survives ``.to()`` and ``copy.deepcopy``;
    the moved model still takes the one-pass add."""
    if move == "reconstructor":
        cfg = ReconstructorConfig(target_size=(W, H), unet_size=(W, H), warp_size=(W, H),
                                  resnet_name="resnet34")
        model = fold_batchnorm(_seeded(Reconstructor(cfg), 3))
        bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
        assert len(bns) > N_BN["resnet34"]
        assert all(m.folded for m in bns)
        return
    model = fold_batchnorm(_stn("resnet34"))
    moved = {"deepcopy": copy.deepcopy,
             "to_device": lambda m: m.to(torch.device("cpu")),
             "to_channels_last": lambda m: m.to(memory_format=torch.channels_last),
             }[move](model).eval()
    bns = [m for m in moved.modules() if isinstance(m, nn.BatchNorm2d)]
    assert len(bns) == N_BN["resnet34"] and all(m.folded for m in bns)
    x = _frames((B, H, W, CIN), torch.float32)
    with torch.no_grad():
        got, counts = _counts(lambda: moved(x))
        want = _unmarked(moved)(x)
    assert counts == (N_BN["resnet34"], 0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bilinear,resnet", [(False, "resnet34"), (True, "resnet50")])
def test_folded_reconstructor_unet_untouched(bilinear, resnet, dtype):
    """A folded Reconstructor's predict: the UNet's logits and theta equal
    those of the same model with every mark cleared, bit for bit, and the
    STN's BNs all take the one-pass add."""
    cfg = ReconstructorConfig(target_size=(W, H), unet_size=(W, H), warp_size=(W, H),
                              unet_bilinear=bilinear, resnet_name=resnet)
    model = fold_batchnorm(_seeded(Reconstructor(cfg, dtype=dtype), 4)).eval()
    full = _unmarked(model)
    x = _frames((B, H, W, 3), torch.float32, seed=5)
    with torch.no_grad():
        got, counts = _counts(lambda: model.predict(x, consistency=False))
        want = full.predict(x, consistency=False)
    assert counts == (N_BN[resnet], 0)
    assert got["logits"].dtype == dtype
    assert torch.equal(got["logits"], want["logits"])
    assert torch.equal(got["theta"], want["theta"])
