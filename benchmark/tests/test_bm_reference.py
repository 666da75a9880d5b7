"""The plain reference against the port's CPU path (its plain twins) at
64x36 in float32, on the benchmark's own seeded weights and renders."""
import copy
import hashlib
import json

import numpy as np
import pytest
import torch

import checks
import inputs
import program
from conftest import BENCH
from reference import ops as rops

SIZE = (64, 36)


def _model_cfg(config):
    """``<config>`` or ``<config>:<resnet>``, the configuration with another
    of the port's trunks, at 64x36 in float32."""
    config, _, resnet = config.partition(":")
    m = copy.deepcopy(json.loads((BENCH / "configs" / f"{config}.json").read_text())["model"])
    m["target_size"] = m["unet_size"] = list(SIZE)
    m["dtype"] = "float32"
    if resnet:
        m["resnet_name"] = resnet
    return m


@pytest.mark.parametrize("config", ["flagship", "bilinear-r50", "flagship:resnext50_32x4d",
                                    "flagship:wide_resnet50_2", "flagship:resnet152"])
def test_predict_matches_the_port(config):
    model_cfg = _model_cfg(config)
    labels, poi = inputs.court((128, 72))
    frames = inputs.render(8, SIZE, labels, poi, 7, "cpu")[0]
    ref = checks.reference_predict(model_cfg, 5, "cpu", frames, labels, poi, (128, 72), 4)
    bundle = program.predict_bundle(model_cfg, inputs.seeded_state_dict(model_cfg, 5, "cpu"),
                                    "cpu", (128, 72), labels, poi, fold_bn=True)
    keep = ["theta", "poi", "consist_score"]
    with torch.inference_mode():
        out = program.predict_program(bundle, keep + ["warp_mask"])(frames)
    answers = [(slice(0, 8), {k: v.numpy() for k, v in out.items()})]
    gaps = checks.predict_gaps(answers, ref, keep)
    assert gaps["theta_gap"] < 1e-5 and gaps["poi_gap"] < 1e-5 and gaps["score_gap"] < 1e-5, gaps
    # K1's labels on the full grid: the template pixel theta maps each pixel to
    warp = checks.warp_mismatches(answers, labels, "cpu")
    assert warp["warp_mismatch"] == 0 and warp["warp_compared"] > 0.9 * 8 * 72 * 128, warp
    # theta follows the frame: answers swapped between frames would show
    spread = np.abs(ref["theta"] - ref["theta"][:1]).max()
    assert spread > 100 * max(gaps["theta_gap"], 1e-7)

    # a perturbed answer fails the comparison
    bad = {k: v.numpy().copy() for k, v in out.items()}
    bad["theta"][3, 0, 0, 2] += 1e-3
    bad["consist_score"][5] *= 1.01
    bad["warp_mask"][2, 40] = (bad["warp_mask"][2, 40] + 1) % 4
    gaps = checks.predict_gaps([(slice(0, 8), bad)], ref, keep)
    assert gaps["theta_gap"] >= 9e-4 and gaps["score_gap"] >= 9e-3
    assert gaps["score_resid"] >= 9e-3
    assert checks.warp_mismatches([(slice(0, 8), bad)], labels, "cpu")["warp_mismatch"] > 100


@pytest.mark.parametrize("config", ["flagship", "bilinear-r50"])
def test_train_step_matches_the_port(config):
    model_cfg = _model_cfg(config)
    train = json.loads((BENCH / "configs" / "flagship.json").read_text())["train"]
    train = dict(train, warp_size=list(SIZE), court_size=list(SIZE))
    labels, poi = inputs.court(SIZE)
    frames, masks, pts, vis = inputs.render(4, SIZE, labels, poi, 9, "cpu")
    batch = {"image": frames.float() / 255, "mask": masks.long(), "weight": torch.ones(4),
             "poi": pts, "nonzeros": vis, "num_nonzero": vis.sum(1).clamp_min(1)}
    model, opt, loss_cfg, step = program.train_program(
        model_cfg, train, inputs.seeded_state_dict(model_cfg, 3, "cpu"), "cpu", 4)
    template = torch.as_tensor(labels).float() / 4
    logs = step(model, opt, batch, 0, template, torch.as_tensor(poi), loss_cfg)
    grads = {n: p.grad.norm().item() for n, p in model.named_parameters()}

    ref = checks.reference_model(model_cfg, 3, "cpu")
    ref_grads = {}

    def on_step(k, m, o, terms):
        ref_grads.update({n: p.grad.norm().item() for n, p in m.named_parameters()})

    losses = rops.train_steps(ref, [batch], template, torch.as_tensor(poi),
                              dict(train, mask_classes=4), on_step)
    assert float(logs["Tot_loss"]) == pytest.approx(losses[0], rel=1e-5)
    med = float(np.median(list(ref_grads.values())))
    live = [n for n in ref_grads if ref_grads[n] >= 1e-3 * med]
    assert len(live) > 0.6 * len(ref_grads)
    gap, leaf, _ = checks.norm_gap(grads, ref_grads, set(ref_grads) - set(live))
    # clipped gradients of one f32 step; BatchNorm's centred sums differ by rounding
    assert gap < 1e-2, (gap, leaf)


# sha256 over each key, dtype, shape and bytes of seeded_state_dict at seed
# 2**31 + 17 on the CPU: the runs of a cell keep their weights bit for bit
DIGESTS = {"flagship": "378709ebfc30f062435bd41daadbfc8c39eaf7f980d825872a0059a6227e7dd9",
           "bilinear-r50": "6e8c0b75dc958af044a24cf6e7785b925b08aab3e2e74f6fc6a4a22ece760bea"}


@pytest.mark.parametrize("config", sorted(DIGESTS))
def test_the_seeded_weights_are_pinned(config):
    model = json.loads((BENCH / "configs" / f"{config}.json").read_text())["model"]
    h = hashlib.sha256()
    for k, v in inputs.seeded_state_dict(model, 2 ** 31 + 17, "cpu").items():
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.contiguous().numpy().tobytes())
    assert h.hexdigest() == DIGESTS[config]


def test_the_residual_branches_last_batchnorm_is_found_in_every_trunk():
    for resnet, last in (("resnet18", "bn2"), ("resnext101_32x8d", "bn3")):
        skeleton = inputs.reference_model(dict(_model_cfg("flagship"), resnet_name=resnet))
        found = inputs._residual_last(skeleton)
        blocks = {n for n, _ in skeleton.named_modules()
                  if n.count(".") == 2 and n.startswith("resnet_reg.layer")}
        assert found == {f"{b}.{last}" for b in blocks}


def test_an_unknown_trunk_raises_a_key_error_that_lists_the_known_ones():
    with pytest.raises(KeyError, match="resnext101_32x8d"):
        inputs.reference_model(dict(_model_cfg("flagship"), resnet_name="resnet52"))
