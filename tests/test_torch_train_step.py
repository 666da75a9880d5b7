"""The training slice of the port against the JAX package (CPU, float32).

One optimizer step of the flagship (UNet deconv 64..1024, ResNet34 on
img+mask, 4 classes, NCAA court) at a reduced size (64x36, batch 3), with
the loss set of ``conf/train_reconstructor.yaml.example`` (focal seg, MSE
rec, RRMSE reproj, focal consistency; RMSprop, lr 1e-4, weight decay 1e-6,
value clip 0.1), against JAX ``make_train_step`` on the same weights and
batch.  The weights are the JAX package's seeded init and are carried with
``compat/jax_params.state_dict_from_jax``, which maps the JAX gradients to
the same names.  Bounds are those of ``tests/test_train_step_parity.py``:
per-loss values rtol 2e-3 / atol 1e-4 (consistency 1e-2 / 1e-3), every
gradient above 1e-6 norm within 2e-2 rel-L2 (over more than 50 leaves),
post-step params atol 2.5e-3, running stats rtol 1e-3 / atol 1e-5.

Also: the consistency warmup gate at a nonzero ``consist_start_iter``,
the pieces of the step against their JAX twins (losses, bilinear warp,
PoI projection, train BN, loader order, dataset samples), the train CLI
end to end on a tiny synthetic set, and the config reader without PyYAML.
"""
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sports_field_homography_tpu.data.assets import open_court_poi as jax_poi
from sports_field_homography_tpu.data.assets import open_court_template as jax_template
from sports_field_homography_tpu.models import Reconstructor as JaxReconstructor
from sports_field_homography_tpu.models import ReconstructorConfig as JaxConfig
from sports_field_homography_tpu.ops.interval_warp import build_interval_table
from sports_field_homography_tpu.train.loop import LossConfig as JaxLossConfig
from sports_field_homography_tpu.train.loop import init_train_state, make_train_step
from sports_field_homography_tpu.train.optim import make_optimizer as jax_optimizer
from sports_field_homography_tpu_torch.compat.jax_params import state_dict_from_jax
from sports_field_homography_tpu_torch.data.assets import open_court_template
from sports_field_homography_tpu_torch.models import Reconstructor, ReconstructorConfig
from sports_field_homography_tpu_torch.train.loop import LossConfig, train_step
from sports_field_homography_tpu_torch.train.optim import make_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COURT = os.path.join(REPO, "assets", "mask_ncaa_v4_nc4_m_onehot.png")
POI = os.path.join(REPO, "assets", "template_ncaa_v4_points.json")
W, H, B = 64, 36, 3
LR, WD = 1e-4, 1e-6
# conf/train_reconstructor.yaml.example; the gate opens at step 1
LOSSES = dict(seg_loss="focal", rec_loss="MSE", reproj_loss="RRMSE",
              consist_loss="focal", seg_lambda=1.0, rec_lambda=1.0,
              reproj_lambda=8.0, consist_lambda=1.0, consist_start_iter=B,
              batch_size=B)


def _variables(model, court, poi, seed):
    """The flagship's initial variables as the JAX package makes them
    (``model.init`` from a seeded key: torch-default conv init, identity
    BN, zero head with identity bias, as ``tests/test_train_step_parity``
    uses them), with the head's kernel nudged from a numpy seed so that
    theta differs per sample."""
    variables = jax.device_get(jax.jit(lambda: model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 3)), court, poi,
        train=False))())
    rng = np.random.default_rng(seed)
    reg = variables["params"]["resnet_reg"]["reg"]
    reg["kernel"] = (rng.standard_normal(reg["kernel"].shape) * 0.02).astype(np.float32)
    return variables


def _batch(seed):
    """Court renders under seeded homographies with their exact masks and
    projected points (``data/synthetic.py``), and varying weights.  Distinct
    realistic frames matter: with frames of noise the samples look alike,
    and the ResNet's last BatchNorm, whose backward subtracts the batch
    mean of a gradient that average pooling made constant over space,
    cancels most of it and leaves the gradient to rounding noise."""
    from sports_field_homography_tpu_torch.data.synthetic import synthetic_samples

    rng = np.random.RandomState(seed)
    frames, labels, anno = synthetic_samples(B, COURT, POI, (W, H), rng=rng)
    nz = anno[..., 2].astype(np.float32)
    return {"image": frames, "mask": labels.astype(np.int64),
            "weight": (0.5 + 0.5 * rng.rand(B, 1)).astype(np.float32),
            "poi": anno[..., :2].astype(np.float32), "nonzeros": nz,
            "num_nonzero": np.maximum(nz.sum(1), 1.0).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX step at step 0 (consistency gated off) and step 1 (on),
    from the same weights: one compiled program, two calls."""
    cfg = JaxConfig(target_size=(W, H), unet_size=(W, H), warp_size=(W, H),
                    resnet_name="resnet34", resnet_input="img+mask")
    model = JaxReconstructor(cfg)
    court = jax_template(COURT, 4, size=(W, H))
    poi = jax_poi(POI, 1)
    variables = _variables(model, court, poi, 3)
    batch = _batch(4)
    optimizer = jax_optimizer("RMSprop", LR, WD, grad_clip_value=0.1)
    step = jax.jit(make_train_step(model, optimizer, JaxLossConfig(**LOSSES),
                                   with_grads=True))
    table = build_interval_table(court)
    out = {}
    for step_no in (0, 1):
        state = init_train_state(variables, optimizer)
        state["step"] = jnp.asarray(step_no, jnp.int32)
        new_state, logs, grads = step(state, batch, jnp.asarray(court),
                                      jnp.asarray(poi), table)
        out[step_no] = jax.device_get((new_state, logs, grads))
    return variables, batch, out


def _port_step(variables, batch, step_no):
    model = Reconstructor(ReconstructorConfig(
        target_size=(W, H), unet_size=(W, H), warp_size=(W, H),
        resnet_name="resnet34", resnet_input="img+mask"))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.train()
    court = torch.from_numpy(open_court_template(COURT, 4, size=(W, H))).float() / 4
    poi = torch.from_numpy(jax_poi(POI, 1)[0])
    opt = make_optimizer("RMSprop", model.parameters(), LR, WD)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logs, grads = train_step(model, opt, tb, step_no, court, poi,
                             LossConfig(**LOSSES), return_grads=True)
    return model, {k: float(v) for k, v in logs.items()}, grads


_BIAS_BEFORE_BN = re.compile(r"double_conv\.[03]\.bias$")


def _rel_l2(ref, got):
    ref = np.asarray(ref, np.float64).ravel()
    got = np.asarray(got, np.float64).ravel()
    return np.linalg.norm(ref - got) / max(np.linalg.norm(ref), 1e-30)


def test_one_step_matches_jax(jax_steps):
    """The measured worst cases are printed (``-s``) for PERF.md."""
    variables, batch, out = jax_steps
    new_state, logs_j, grads_j = out[1]
    model, logs, grads = _port_step(variables, batch, 1)

    worst = {}
    for k in ("Seg_loss", "Rec_loss", "Reproj_loss", "Tot_loss", "Cons_loss"):
        tol = dict(rtol=1e-2, atol=1e-3) if k == "Cons_loss" else dict(rtol=2e-3, atol=1e-4)
        np.testing.assert_allclose(logs[k], float(logs_j[k]), err_msg=k, **tol)
        worst[k] = abs(logs[k] - float(logs_j[k])) / max(abs(float(logs_j[k])), 1e-30)
    assert logs["Cons_loss"] > 0

    want = state_dict_from_jax({"params": grads_j})
    checked, worst_grad = 0, (-1.0, "")
    for name, g in grads.items():
        ref = want[name].numpy()
        if _BIAS_BEFORE_BN.search(name):
            # a conv bias feeding a train-mode BN: the true gradient is 0,
            # both sides hold rounding noise far below the weight's
            w = want[name.replace(".bias", ".weight")].numpy()
            for side in (ref, g.numpy()):
                assert np.linalg.norm(side) < 1e-3 * np.linalg.norm(w), name
            continue
        if np.linalg.norm(ref) < 1e-6:
            continue
        rel = _rel_l2(ref, g.numpy())
        assert rel < 2e-2, (name, rel)
        worst_grad = max(worst_grad, (rel, name))
        checked += 1
    assert checked > 50

    post = state_dict_from_jax({"params": new_state["params"],
                                "batch_stats": new_state["batch_stats"]})
    worst_param = worst_stat = 0.0
    for name, v in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            assert int(v) == 1, name
            continue
        got, ref = v.numpy().astype(np.float64), post[name].numpy().astype(np.float64)
        if "running_" in name:
            np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5, err_msg=name)
            worst_stat = max(worst_stat, float(np.max(np.abs(got - ref))))
        else:
            np.testing.assert_allclose(got, ref, atol=2.5e-3, err_msg=name)
            worst_param = max(worst_param, float(np.max(np.abs(got - ref))))
    print(f"\nworst rel loss diffs {worst}; worst grad rel-L2 {worst_grad[0]:.3e} "
          f"({worst_grad[1]}) over {checked} leaves; post-step params max-abs "
          f"{worst_param:.3e}; running stats max-abs {worst_stat:.3e}")


def test_consistency_gate_at_nonzero_start(jax_steps):
    """consist_start_iter = B: at step 0 the consistency term is gated to
    zero on both sides (and adds no gradient); at step 1 it counts."""
    variables, batch, out = jax_steps
    _, logs0, grads0 = _port_step(variables, batch, 0)
    jlogs0, jgrads0 = out[0][1], out[0][2]
    assert logs0["Cons_loss"] == 0.0 and float(jlogs0["Cons_loss"]) == 0.0
    np.testing.assert_allclose(
        logs0["Tot_loss"], logs0["Seg_loss"] + logs0["Rec_loss"] + logs0["Reproj_loss"],
        rtol=1e-6)
    np.testing.assert_allclose(logs0["Tot_loss"], float(jlogs0["Tot_loss"]),
                               rtol=2e-3, atol=1e-4)
    assert float(out[1][1]["Cons_loss"]) > 0
    want = state_dict_from_jax({"params": jgrads0})
    for name in ("inc.double_conv.0.weight", "resnet_reg.reg.weight"):
        assert _rel_l2(want[name].numpy(), grads0[name].numpy()) < 2e-2, name


def test_consistency_loss_takes_given_labels():
    """compute_losses' consistency targets: trunc(warp * classes) by
    default, or the labels it is given."""
    from sports_field_homography_tpu_torch.models.losses import focal_loss_map
    from sports_field_homography_tpu_torch.train.loop import (compute_losses,
                                                               consistency_labels)

    rng = np.random.default_rng(8)
    preds = {"logits": torch.from_numpy(rng.standard_normal((2, 5, 6, 4)).astype(np.float32)),
             "warp_mask": torch.from_numpy(rng.integers(0, 4, (2, 5, 6)) / 4.0).float()}
    batch = {"mask": torch.zeros((2, 5, 6), dtype=torch.int64), "weight": torch.ones(2)}
    cfg = LossConfig(seg_loss=None, rec_loss=None, consist_loss="focal")
    own = consistency_labels(preds["warp_mask"], 4)
    assert torch.equal(own, (preds["warp_mask"] * 4).to(torch.int32))
    _, logs = compute_losses(preds, batch, 0, cfg, 4)
    _, same = compute_losses(preds, batch, 0, cfg, 4, consist_labels=own)
    given = torch.full_like(own, 2)
    _, other = compute_losses(preds, batch, 0, cfg, 4, consist_labels=given)
    assert float(logs["Cons_loss"]) == float(same["Cons_loss"])
    np.testing.assert_allclose(float(other["Cons_loss"]),
                               float(focal_loss_map(preds["logits"], given).mean()), rtol=1e-6)
    assert float(other["Cons_loss"]) != float(logs["Cons_loss"])


def test_losses_match_jax():
    from sports_field_homography_tpu.models import losses as jl
    from sports_field_homography_tpu_torch.models import losses as tl

    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 6, 8, 4)).astype(np.float32) * 3
    labels = rng.integers(0, 4, (2, 6, 8))
    a, b = rng.random((2, 6, 8)).astype(np.float32), rng.random((2, 6, 8)).astype(np.float32) * 3
    pairs = [
        (tl.focal_loss_map(torch.from_numpy(logits), torch.from_numpy(labels)),
         jl.focal_loss_map(logits, labels)),
        (tl.cross_entropy_map(torch.from_numpy(logits), torch.from_numpy(labels)),
         jl.cross_entropy_map(logits, labels)),
        (tl.mse_map(torch.from_numpy(a), torch.from_numpy(b)), jl.mse_map(a, b)),
        (tl.smooth_l1_map(torch.from_numpy(a), torch.from_numpy(b)), jl.smooth_l1_map(a, b)),
    ]
    p, t = rng.random((2, 5, 2)).astype(np.float32), rng.random((2, 5, 2)).astype(np.float32)
    nz = (rng.random((2, 5)) > 0.3).astype(np.float32)
    nn = np.maximum(nz.sum(1), 1).astype(np.float32)
    w = rng.random((2, 1)).astype(np.float32)
    for red in ("mean", "sum", "none"):
        pairs.append((tl.reprojection_loss(*map(torch.from_numpy, (p, t, nz, nn)), red),
                      jl.reprojection_loss(p, t, nz, nn, red)))
    pairs.append((tl.per_sample_weighted(torch.from_numpy(a), torch.from_numpy(w)),
                  jl.per_sample_weighted(a, w)))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_bilinear_warp_and_poi_match_jax():
    """F.grid_sample (the port's training warp) against the JAX training
    path's gather-free ``warp_bilinear_interval``, value and gradient in
    theta; and ``transform_poi``."""
    from sports_field_homography_tpu.geometry.homography import transform_poi as jtp
    from sports_field_homography_tpu.ops.interval_warp import warp_bilinear_interval
    from sports_field_homography_tpu_torch.geometry.homography import transform_poi
    from sports_field_homography_tpu_torch.geometry.warp import warp_bilinear

    court = jax_template(COURT, 4, size=(128, 72))
    table = build_interval_table(court)
    rng = np.random.default_rng(6)
    theta = (np.eye(3) + rng.standard_normal((3, 3, 3)) * 0.05).astype(np.float32)
    cot = rng.standard_normal((3, 36, 64)).astype(np.float32)

    def f(th):
        return jnp.sum(warp_bilinear_interval(table, th, (36, 64)) * cot)

    want = np.asarray(warp_bilinear_interval(table, jnp.asarray(theta), (36, 64)))
    want_g = np.asarray(jax.grad(f)(jnp.asarray(theta)))
    th = torch.from_numpy(theta).requires_grad_()
    tmpl = torch.from_numpy(court[0, :, :, 0])
    got = warp_bilinear(tmpl, th, (36, 64))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), want_g, rtol=1e-3, atol=1e-3)

    poi = jax_poi(POI, 1)[0]
    np.testing.assert_allclose(
        transform_poi(torch.from_numpy(theta)[:, None], torch.from_numpy(poi)).numpy(),
        np.asarray(jtp(jnp.asarray(theta), jnp.asarray(np.tile(poi[None], (3, 1, 1))))),
        rtol=1e-5, atol=1e-5)


def test_train_batchnorm_matches_jax():
    from sports_field_homography_tpu.models.layers import BatchNorm as JaxBN
    from sports_field_homography_tpu_torch.models.layers import bn_train

    rng = np.random.default_rng(7)
    x = (rng.standard_normal((3, 5, 7, 16)) * 2 + 1).astype(np.float32)
    mod = JaxBN(16)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), True)
    v = jax.tree.map(lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32), v)
    want, upd = mod.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    bn = torch.nn.BatchNorm2d(16)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(np.array(v["params"]["scale"])))
        bn.bias.copy_(torch.from_numpy(np.array(v["params"]["bias"])))
        bn.running_mean.copy_(torch.from_numpy(np.array(v["batch_stats"]["mean"])))
        bn.running_var.copy_(torch.from_numpy(np.array(v["batch_stats"]["var"])))
    got = bn_train(torch.from_numpy(x), bn, dim=-1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), rtol=1e-6, atol=1e-6)
    assert int(bn.num_batches_tracked) == 1


@pytest.fixture(scope="module")
def tiny_set(tmp_path_factory):
    from sports_field_homography_tpu_torch.data.synthetic import write_synthetic_dataset

    root = tmp_path_factory.mktemp("synth")
    write_synthetic_dataset(str(root), 6, 2, COURT, POI, size=(W, H), seed=1)
    return root


def test_loader_and_dataset_match_jax(tiny_set):
    from sports_field_homography_tpu.data.dataset import BasicDataset as JaxDataset
    from sports_field_homography_tpu.data.loader import Loader as JaxLoader
    from sports_field_homography_tpu_torch.cli.train import prepare_dataloader

    frames, masks, anno = (str(tiny_set / d) for d in ("frames", "masks", "anno"))
    train, n_train, val, n_val = prepare_dataloader(
        frames, masks, anno, ["poi", "reproj_mse"], ["val_game"], 4, (W, H),
        data_seed=3, num_workers=1)
    assert (n_train, n_val) == (6, 2)
    jds = JaxDataset(train.dataset.ids, frames, masks, anno, ["poi", "reproj_mse"],
                     4, target_size=(W, H), raw_uint8=True)
    for i in (0, 5):
        got, want = train.dataset[i], jds[i]
        for k in ("image", "mask", "poi", "nonzeros", "num_nonzero", "weight"):
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    jl = JaxLoader(jds, 4, shuffle=True, num_workers=1, pad_last=False, seed=3)
    for epoch in (0, 1):
        train.set_epoch(epoch)
        jl.set_epoch(epoch)
        got = [b["name"] for b in train]
        want = [b["name"] for b in jl]
        assert got == want and [len(b) for b in got] == [4, 2]


def test_train_cli_writes_a_checkpoint_the_predict_cli_loads(tiny_set, tmp_path):
    from sports_field_homography_tpu_torch.cli import predict as predict_cli
    from sports_field_homography_tpu_torch.cli import train as train_cli

    cp_dir = tmp_path / "cp" / "run"
    conf = dict(img_dir=str(tiny_set / "frames"), mask_dir=str(tiny_set / "masks"),
                anno_dir=str(tiny_set / "anno"), anno_keys=["poi", "reproj_mse"],
                val_names=["val_game"], court_img=COURT, court_poi=POI,
                court_size=[W, H], cp_dir=str(cp_dir) + "/", epochs=1, batchsize=4,
                target_size=[W, H], unet_size=[W, H], warp_size=[W, H],
                resnet_name="resnet18", weight_decay=1e-6, val_step_n=2,
                **{k: v for k, v in LOSSES.items() if k != "batch_size"},
                compute_dtype="float32", device="cpu")
    conf["consist_start_iter"] = 0
    conf_path = tmp_path / "conf.json"
    conf_path.write_text(json.dumps(conf))
    hist = train_cli.main(["-c", str(conf_path)], num_data_workers=1)
    assert len(hist["steps"]) == 2 and len(hist["validations"]) == 1
    for step in hist["steps"]:
        assert all(np.isfinite(v) for v in step.values()) and step["Cons_loss"] > 0
    assert sorted(os.listdir(cp_dir)) == ["CP_epoch1.pth", "conf.yaml"]

    dst = tmp_path / "pred"
    predict_cli.process(["--img_dir", str(tiny_set / "frames" / "val_game"),
                         "--load", str(cp_dir / "CP_epoch1.pth"), "--dst_dir", str(dst),
                         "--req_outputs", "theta,consistency", "--batchsize", "2",
                         "--court_img", COURT, "--court_poi", POI],
                        num_data_workers=1)
    out = json.loads((dst / "val_game_court.json").read_text())
    assert out.pop("model") == "run" and len(out) == 2
    for rec in out.values():
        assert np.isfinite(rec["score"]) and np.isfinite(rec["theta"]).all()


def test_train_cli_refuses_what_is_not_ported(tmp_path):
    from sports_field_homography_tpu_torch.cli import train as train_cli

    base = ["--img_dir", "f", "--mask_dir", "m", "--anno_dir", "a", "--cp_dir",
            str(tmp_path), "--device", "cpu"]
    for extra, match in ((["--load", "CP_epoch1.orbax"], "export_torch_checkpoint"),
                         (["--resnet_pretrained", "resnet34"], "download")):
        with pytest.raises(NotImplementedError, match=match):
            train_cli.main(base + extra)
    # multi-device training is ported (tests/test_torch_data_parallel.py); its
    # flags are refused before any rank starts only where they cannot run
    for extra, match in ((["--num_devices", "2", "--batchsize", "3"], "not divisible"),
                         (["--num_hosts", "2"], "--coordinator host:port"),
                         (["--num_devices", "2", "--device", "cuda"], "2 CUDA devices")):
        with pytest.raises((ValueError, SystemExit), match=match):
            train_cli.main(base + extra)


def test_config_reads_json_without_pyyaml(tmp_path, monkeypatch):
    from sports_field_homography_tpu_torch.utils.config import parse_config

    good = tmp_path / "conf.yaml"
    good.write_text(json.dumps({"lr": 1e-6, "aug": None, "val_names": ["g"]}))
    bad = tmp_path / "bad.yaml"
    bad.write_text("lr: 0.0001\nval_names: [g]\n")
    assert parse_config(str(good)) == {"lr": 1e-6, "aug": None, "val_names": ["g"]}
    assert parse_config(str(bad)) == {"lr": 0.0001, "val_names": ["g"]}
    monkeypatch.setitem(sys.modules, "yaml", None)      # import yaml -> ImportError
    assert parse_config(str(good))["lr"] == 1e-6
    with pytest.raises(RuntimeError, match="PyYAML is not installed"):
        parse_config(str(bad))
    assert parse_config(str(tmp_path / "missing.yaml")) is None
