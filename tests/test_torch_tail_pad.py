"""``tail: pad`` in the port against the JAX package's masked step (CPU,
float32).

The JAX loader pads the last train batch with replicas of its last sample
after the ``num_valid`` real ones, and the JAX package runs such a batch
through its ``masked_bn`` program: loss means and train-mode BatchNorm
moments over the valid rows only.  That is the step on the batch's real
rows, so the port pads nothing: its train loader yields the true smaller
tail batch and the ordinary step runs on it.  One step of the flagship
(UNet deconv, ResNet18 on img+mask, 64x36) on a true tail of 3 rows, with
the example conf's losses, is held to the JAX
``make_train_step(masked_bn=True)`` on those rows padded to 5, at
``tests/test_train_step_parity.py``'s bounds: losses rtol 2e-3 / atol 1e-4
(consistency 1e-2 / 1e-3), gradients rel-L2 < 2e-2, post-step params atol
2.5e-3, running stats rtol 1e-3 / atol 1e-5.  So is an accumulated step
(``grad_accum=2``) whose second micro-batch is a true tail of 2 rows,
against JAX's accumulated masked step on both padded to 3 (the JAX
default with accumulation).

The helpers here serve ``tests/test_torch_grad_accum.py`` too.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
W, H = 64, 36
LR, WD = 1e-4, 1e-6
# conf/train_reconstructor.yaml.example's losses, the gate open
LOSSES = dict(seg_loss="focal", rec_loss="MSE", reproj_loss="RRMSE", consist_loss="focal",
              seg_lambda=1.0, rec_lambda=1.0, reproj_lambda=8.0, consist_lambda=1.0,
              consist_start_iter=0)
MODEL = dict(target_size=(W, H), unet_size=(W, H), warp_size=(W, H), resnet_name="resnet18",
             resnet_input="img+mask")


def jax_model(seed, **extra):
    """The JAX Reconstructor and its seeded initial variables (the head's
    kernel nudged from a numpy seed so that theta differs per sample)."""
    model = JaxReconstructor(JaxConfig(**dict(MODEL, **extra)))
    court, poi = jax_template(COURT, 4, size=(W, H)), jax_poi(POI, 1)
    variables = jax.device_get(jax.jit(lambda: model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 3)), court, poi, train=False))())
    reg = variables["params"]["resnet_reg"]["reg"]
    reg["kernel"] = (np.random.default_rng(seed).standard_normal(reg["kernel"].shape)
                     * 0.02).astype(np.float32)
    return model, variables


def jax_step(model, variables, batch, losses, **step_kw):
    """One JAX step with its gradients: (new state, logs, grads)."""
    optimizer = jax_optimizer("RMSprop", LR, WD, grad_clip_value=0.1)
    step = jax.jit(make_train_step(model, optimizer, JaxLossConfig(**losses),
                                   with_grads=True, **step_kw))
    court = jax_template(COURT, 4, size=(W, H))
    out = step(init_train_state(variables, optimizer), batch, jnp.asarray(court),
               jnp.asarray(jax_poi(POI, 1)), build_interval_table(court))
    return jax.device_get(out)


def make_batch(n, seed, uv=False):
    """``n`` synthetic court renders with their masks and points, varying
    weights, and (``uv``) seeded UV maps on the court pixels."""
    from sports_field_homography_tpu_torch.data.synthetic import synthetic_samples

    rng = np.random.RandomState(seed)
    frames, labels, anno = synthetic_samples(n, COURT, POI, (W, H), rng=rng)
    nz = anno[..., 2].astype(np.float32)
    batch = {"image": frames, "mask": labels.astype(np.int64),
             "weight": (0.5 + 0.5 * rng.rand(n, 1)).astype(np.float32),
             "poi": anno[..., :2].astype(np.float32), "nonzeros": nz,
             "num_nonzero": np.maximum(nz.sum(1), 1.0).astype(np.float32)}
    if uv:
        batch["uv"] = (rng.rand(n, H, W, 2) * (labels[..., None] > 0)).astype(np.float32)
    return batch


def port_model(variables, **extra):
    model = Reconstructor(ReconstructorConfig(**dict(MODEL, **extra)))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model.train()


def port_step(model, batch, losses, step_no=0):
    court = torch.from_numpy(open_court_template(COURT, 4, size=(W, H))).float() / 4
    poi = torch.from_numpy(jax_poi(POI, 1)[0])
    opt = make_optimizer("RMSprop", model.parameters(), LR, WD)

    def tensors(b):
        return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in b.items()}

    micro = [tensors(b) for b in batch] if isinstance(batch, list) else tensors(batch)
    logs, grads = train_step(model, opt, micro, step_no, court, poi, LossConfig(**losses),
                             return_grads=True)
    return {k: float(v) for k, v in logs.items()}, grads


_BIAS_BEFORE_BN = re.compile(r"double_conv\.[03]\.bias$")


def _rel_l2(ref, got):
    ref = np.asarray(ref, np.float64).ravel()
    got = np.asarray(got, np.float64).ravel()
    return np.linalg.norm(ref - got) / max(np.linalg.norm(ref), 1e-30)


def assert_step_matches(model, logs, grads, new_state, logs_j, grads_j, n_steps=1):
    """The port's step against the JAX one at the slice bounds."""
    for k, v in logs_j.items():
        tol = dict(rtol=1e-2, atol=1e-3) if k == "Cons_loss" else dict(rtol=2e-3, atol=1e-4)
        np.testing.assert_allclose(logs[k], float(v), err_msg=k, **tol)
    assert logs["Cons_loss"] > 0
    want = state_dict_from_jax({"params": grads_j})
    checked = 0
    for name, g in grads.items():
        ref = want[name].numpy()
        if _BIAS_BEFORE_BN.search(name):
            # a conv bias feeding a train-mode BN: its true gradient is 0
            w = want[name.replace(".bias", ".weight")].numpy()
            for side in (ref, g.numpy()):
                assert np.linalg.norm(side) < 1e-3 * np.linalg.norm(w), name
            continue
        if np.linalg.norm(ref) < 1e-6:
            continue
        assert _rel_l2(ref, g.numpy()) < 2e-2, (name, _rel_l2(ref, g.numpy()))
        checked += 1
    assert checked > 50
    post = state_dict_from_jax({"params": new_state["params"],
                                "batch_stats": new_state["batch_stats"]})
    for name, v in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            assert int(v) == n_steps, name
            continue
        got, ref = v.numpy().astype(np.float64), post[name].numpy().astype(np.float64)
        if "running_" in name:
            np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(got, ref, atol=2.5e-3, err_msg=name)


def pad_batch(batch, total):
    """The JAX loader's padding: replicas of the last row, and ``valid``."""
    n = len(batch["image"])
    idx = np.concatenate([np.arange(n), np.full(total - n, n - 1)])
    out = {k: v[idx] for k, v in batch.items()}
    out["valid"] = np.arange(total) < n
    return out


def test_true_tail_matches_jax_masked_step():
    # seeds of the well-posed case of tests/test_torch_train_step.py: at
    # batch 3 one ulp on the weights moves some seeds' f32 gradients by up
    # to 3e-2 (PERF.md section 6), on either side
    model, variables = jax_model(3)
    true_tail = make_batch(3, 4)
    new_state, logs_j, grads_j = jax_step(model, variables, pad_batch(true_tail, 5),
                                          dict(LOSSES, batch_size=5), masked_bn=True)
    port = port_model(variables)
    logs, grads = port_step(port, true_tail, dict(LOSSES, batch_size=5))
    assert_step_matches(port, logs, grads, new_state, logs_j, grads_j)


def test_accumulated_true_tail_matches_jax_padded():
    model, variables = jax_model(3)
    full, tail = make_batch(3, 4), {k: v[:2] for k, v in make_batch(3, 5).items()}
    padded = [pad_batch(full, 3), pad_batch(tail, 3)]
    stacked = {k: np.stack([m[k] for m in padded]) for k in padded[0]}
    losses = dict(LOSSES, batch_size=3)
    new_state, logs_j, grads_j = jax_step(model, variables, stacked, losses, grad_accum=2,
                                          masked_bn=True)
    port = port_model(variables)
    logs, grads = port_step(port, [full, tail], losses)
    assert_step_matches(port, logs, grads, new_state, logs_j, grads_j, n_steps=2)


def test_train_loader_yields_the_true_tail(tmp_path):
    """The train CLI's loaders (``tail`` exact or pad alike): 7 train
    frames at batch 3 give 3, 3 and the true tail of 1, every row real."""
    from sports_field_homography_tpu_torch.cli.train import prepare_dataloader
    from sports_field_homography_tpu_torch.data.synthetic import write_synthetic_dataset

    write_synthetic_dataset(str(tmp_path), 7, 2, COURT, POI, size=(32, 18), seed=1)
    train, n_train, val, n_val = prepare_dataloader(
        str(tmp_path / "frames"), str(tmp_path / "masks"), str(tmp_path / "anno"),
        ["poi", "reproj_mse"], ["val_game"], 3, (32, 18), num_workers=2)
    assert (n_train, n_val) == (7, 2)
    for loader, sizes in ((train, [3, 3, 1]), (val, [2])):
        batches = list(loader)
        assert [len(b["image"]) for b in batches] == sizes
        assert [b["num_valid"] for b in batches] == sizes
        assert all(b["valid"].all() for b in batches)
