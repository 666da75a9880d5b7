"""Validation metrics, optimizers and point normalization of the port's
training slice against the JAX package (CPU, float32).

* ``train/evaluate.eval_step`` against JAX ``make_eval_step`` on the same
  weights (resnet18 img+mask at 64x36, BN running stats away from their
  init) and a batch of synthetic court renders: every metric within
  rtol 1e-3 (the logits bound of ``docs/PARITY.md`` is 2e-4 absolute;
  reprojection in pixels scales theta's 2e-4 by the frame size).
* ``train/optim`` (torch's RMSprop, SGD and Adam behind value clipping at
  0.1 and coupled weight decay) against the JAX package's optax chains:
  three steps on the same gradients, params within rtol 1e-5.
* ``normalize_points`` / ``denormalize_points``.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sports_field_homography_tpu.data.assets import open_court_poi as jax_poi
from sports_field_homography_tpu.data.assets import open_court_template as jax_template
from sports_field_homography_tpu.models import Reconstructor as JaxReconstructor
from sports_field_homography_tpu.models import ReconstructorConfig as JaxConfig
from sports_field_homography_tpu.train.evaluate import make_eval_step
from sports_field_homography_tpu.train.optim import make_optimizer as jax_optimizer
from sports_field_homography_tpu_torch.compat.jax_params import state_dict_from_jax
from sports_field_homography_tpu_torch.data.assets import open_court_template
from sports_field_homography_tpu_torch.data.synthetic import synthetic_samples
from sports_field_homography_tpu_torch.models import Reconstructor, ReconstructorConfig
from sports_field_homography_tpu_torch.train.evaluate import eval_step
from sports_field_homography_tpu_torch.train.optim import clip_gradients, make_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COURT = os.path.join(REPO, "assets", "mask_ncaa_v4_nc4_m_onehot.png")
POI = os.path.join(REPO, "assets", "template_ncaa_v4_points.json")
W, H, B = 64, 36, 3


def test_eval_metrics_match_jax():
    cfg = dict(target_size=(W, H), unet_size=(W, H), warp_size=(W, H),
               resnet_name="resnet18", resnet_input="img+mask")
    model = JaxReconstructor(JaxConfig(**cfg))
    court, poi = jax_template(COURT, 4, size=(W, H)), jax_poi(POI, 1)
    variables = jax.device_get(jax.jit(lambda: model.init(
        jax.random.PRNGKey(1), jnp.zeros((1, H, W, 3)), court, poi, train=False))())
    rng = np.random.default_rng(2)
    variables["batch_stats"] = jax.tree.map(          # running stats off init
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if a.ndim else a, variables["batch_stats"])
    reg = variables["params"]["resnet_reg"]["reg"]
    reg["kernel"] = (rng.standard_normal(reg["kernel"].shape) * 0.02).astype(np.float32)

    frames, labels, anno = synthetic_samples(B, COURT, POI, (W, H),
                                             rng=np.random.RandomState(3))
    nz = anno[..., 2].astype(np.float32)
    batch = {"image": frames, "mask": labels.astype(np.int64),
             "weight": rng.uniform(0.5, 1.0, (B, 1)).astype(np.float32),
             "poi": anno[..., :2].astype(np.float32), "nonzeros": nz,
             "num_nonzero": np.maximum(nz.sum(1), 1.0).astype(np.float32)}
    want = make_eval_step(model, court, poi, (W, H), True)(variables, batch)

    port = Reconstructor(ReconstructorConfig(**cfg))
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    port.eval()
    got = eval_step(port, {k: torch.from_numpy(v) for k, v in batch.items()},
                    torch.from_numpy(open_court_template(COURT, 4, size=(W, H))).float() / 4,
                    torch.from_numpy(poi[0]), (W, H))
    assert set(got) == {"seg", "rec", "consist", "reproj_sum", "reproj_px_sum"}
    for k, v in got.items():
        np.testing.assert_allclose(float(v), float(want[k]), rtol=1e-3, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("opt", ["RMSprop", "SGD", "Adam"])
def test_optimizers_match_optax_chains(opt):
    rng = np.random.default_rng(4)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 0.2).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    lr, wd = 1e-3, 1e-2

    tx = jax_optimizer(opt, lr, wd, grad_clip_value=0.1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    optimizer = make_optimizer(opt, tp.values(), lr, wd)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        clip_gradients(tp.values())
        optimizer.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=f"{opt} {k}")


def test_point_normalization_matches_jax():
    from sports_field_homography_tpu.geometry import homography as jh
    from sports_field_homography_tpu_torch.geometry import homography as th

    pts = np.random.default_rng(5).uniform(0, 640, (2, 9, 2)).astype(np.float32)
    for size in ((640, 360), (1280, 720)):
        np.testing.assert_allclose(
            th.normalize_points(torch.from_numpy(pts), size).numpy(),
            np.asarray(jh.normalize_points(jnp.asarray(pts), size)), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            th.denormalize_points(torch.from_numpy(pts / 640), size).numpy(),
            np.asarray(jh.denormalize_points(jnp.asarray(pts / 640), size)),
            rtol=1e-6, atol=1e-5)
