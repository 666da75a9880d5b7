"""The plain reference against the port's CPU path (its plain twins) at
64x36 in float32, on the benchmark's own seeded weights and renders."""
import copy
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
    m = copy.deepcopy(json.loads((BENCH / "configs" / f"{config}.json").read_text())["model"])
    m["target_size"] = m["unet_size"] = list(SIZE)
    m["dtype"] = "float32"
    return m


@pytest.mark.parametrize("config", ["flagship", "bilinear-r50"])
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
