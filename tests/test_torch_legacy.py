"""The legacy model family, its evaluation and ``dice_coeff``: the port
against the JAX package (CPU, float32, 64x36).

The three legacy models (``UNet``, ``UNetSTN``, ``CourtReconstruction``),
deconv and bilinear, on weights made from a numpy seed in the JAX tree and
carried by ``compat/jax_params.state_dict_from_jax`` (the UNet under
``core``, the head under ``reg``; ``fc1``'s width from the 64x36 input's
2x4 bottleneck).  Bounds: logits rtol 1e-3 / atol 2e-4, theta max-abs
2e-4, and the template projected by JAX's theta within 1e-5 of JAX's
projection.  ``dice_coeff`` is first held to a value worked out by hand,
then the port to JAX at 1e-6; ``eval_net`` (cross entropy and dice) and
``eval_stn`` to JAX over two batches at rtol 1e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sports_field_homography_tpu.models import legacy as jax_legacy
from sports_field_homography_tpu.models.losses import dice_coeff as jax_dice
from sports_field_homography_tpu.train.evaluate import eval_net as jax_eval_net
from sports_field_homography_tpu.train.evaluate import eval_stn as jax_eval_stn
from sports_field_homography_tpu.utils import hubconf as jax_hub
from sports_field_homography_tpu_torch.compat.jax_params import state_dict_from_jax
from sports_field_homography_tpu_torch.models import legacy
from sports_field_homography_tpu_torch.models.losses import dice_coeff
from sports_field_homography_tpu_torch.train.evaluate import eval_net, eval_stn
from sports_field_homography_tpu_torch.utils import hubconf

W, H, B = 64, 36, 2
KINDS = ("unet", "stn", "court")


def _models(kind, bilinear, n_classes=4):
    """(JAX model, port model) of one kind."""
    if kind == "unet":
        return (jax_legacy.UNet(n_classes=n_classes, bilinear=bilinear),
                legacy.UNet(n_classes, bilinear=bilinear))
    if kind == "stn":
        return (jax_legacy.UNetSTN(n_classes=n_classes, bilinear=bilinear),
                legacy.UNetSTN(n_classes, bilinear=bilinear, input_size=(W, H)))
    return (jax_legacy.CourtReconstruction(n_classes=n_classes, target_size=(W, H),
                                           bilinear=bilinear),
            legacy.CourtReconstruction(n_classes, target_size=(W, H), bilinear=bilinear))


def _inputs(seed=0, n=B):
    rng = np.random.default_rng(seed)
    x = rng.random((n, H, W, 3), dtype=np.float32)
    template = np.tile((rng.integers(0, 4, (1, H, W, 1)) / 4.0).astype(np.float32),
                       (n, 1, 1, 1))
    return x, template


def _seeded(model, kind, seed, n_classes=4):
    """JAX variables from a numpy seed: He-scaled kernels, BN scale and
    running variance in [0.5, 1.5], small biases and means, and the
    identity head nudged so that theta differs per sample."""
    x, template = _inputs()
    args = (x,) if kind == "unet" else (x, template)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args, train=False))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        keys = [p.key for p in path]
        if "fc2" in keys:
            if keys[-1] == "kernel":
                return (rng.standard_normal(leaf.shape) * 0.05).astype(np.float32)
            ident = (1, 0, 0, 0, 1, 0) if kind == "stn" else (1, 0, 0, 0, 1, 0, 0, 0, 1)
            return np.asarray(ident, np.float32)
        if keys[-1] == "kernel":
            std = np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) * std).astype(np.float32)
        if keys[-1] in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port(model, variables):
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model.eval()


@pytest.fixture(scope="module", params=[(k, b) for k in KINDS for b in (False, True)],
                ids=lambda p: f"{p[0]}-{'bilinear' if p[1] else 'deconv'}")
def case(request):
    kind, bilinear = request.param
    jm, pm = _models(kind, bilinear)
    variables = _seeded(jm, kind, 1 + KINDS.index(kind))
    x, template = _inputs()
    if kind == "unet":
        return kind, jm, variables, _port(pm, variables), x, template, None
    (logits, proj), inter = jm.apply(variables, x, template, train=False,
                                     capture_intermediates=True, mutable=["intermediates"])
    theta = np.array(inter["intermediates"]["reg"]["__call__"][0])
    jax_out = (np.asarray(logits), np.asarray(proj), theta)
    return kind, jm, variables, _port(pm, variables), x, template, jax_out


def test_logits_theta_and_projection_match_jax(case):
    kind, jm, variables, pm, x, template, jax_out = case
    thetas = []
    hook = None
    if kind != "unet":
        hook = pm.reg.register_forward_hook(lambda m, i, o: thetas.append(o))
    with torch.no_grad():
        out = pm(torch.from_numpy(x)) if kind == "unet" else \
            pm(torch.from_numpy(x), torch.from_numpy(template))
    if kind == "unet":
        want = np.asarray(jm.apply(variables, x, train=False))
        assert out.shape == (B, H, W, 4)
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-3, atol=2e-4)
        return
    hook.remove()
    logits, proj = out
    want_logits, want_proj, want_theta = jax_out
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=1e-3, atol=2e-4)
    theta = thetas[0].numpy()
    assert theta.shape == want_theta.shape == (B, 6 if kind == "stn" else 9)
    assert np.abs(theta - want_theta).max() <= 2e-4
    assert np.ptp(want_theta, axis=0).max() > 1e-3           # the samples differ
    shape = (-1, 2, 3) if kind == "stn" else (-1, 3, 3)
    with torch.no_grad():
        got = pm.project(torch.from_numpy(want_theta).reshape(shape),
                         torch.from_numpy(template))
        # the forward's projection is the port's theta through the same function
        own = pm.project(thetas[0].reshape(shape), torch.from_numpy(template))
    assert got.shape == want_proj.shape == (B, H, W)
    assert np.abs(got.numpy() - want_proj).max() <= 1e-5
    assert torch.equal(own, proj)
    assert 0.01 < (want_proj > 0).mean() < 1.0                # the template is in view


def test_dice_coeff_hand_value_then_port():
    pred = np.array([[1, 0, 1, 1], [0, 0, 1, 0]], np.float32)
    target = np.array([[1, 1, 0, 1], [0, 1, 1, 0]], np.float32)
    eps = 1e-4
    # sample 0: 2 * 2 / (3 + 3); sample 1: 2 * 1 / (1 + 2)
    want = ((4 + eps) / (6 + eps) + (2 + eps) / (3 + eps)) / 2
    assert abs(float(jax_dice(jnp.asarray(pred), jnp.asarray(target))) - want) <= 1e-6
    rng = np.random.default_rng(3)
    p = (rng.random((3, 9, 11)) > 0.5).astype(np.float32)
    t = (rng.random((3, 9, 11)) > 0.4).astype(np.float32)
    for a, b in ((pred, target), (p, t)):
        got = float(dice_coeff(torch.from_numpy(a), torch.from_numpy(b)))
        assert abs(got - float(jax_dice(jnp.asarray(a), jnp.asarray(b)))) <= 1e-6


def _batches(n_classes, seed=5):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8),
             "mask": rng.integers(0, max(n_classes, 2), (B, H, W)).astype(np.int64)}
            for _ in range(2)]


@pytest.mark.parametrize("n_classes", [4, 1])
def test_eval_net_matches_jax(n_classes):
    jm, pm = _models("unet", False, n_classes)
    variables = _seeded(jm, "unet", 7)
    batches = _batches(n_classes)
    want = jax_eval_net(jm, variables, batches, n_classes)["val_score"]
    got = eval_net(_port(pm, variables), batches, n_classes)["val_score"]
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("kind", ["stn", "court"])
def test_eval_stn_matches_jax(kind):
    jm, pm = _models(kind, True)
    variables = _seeded(jm, kind, 9)
    batches = _batches(4)
    _, template = _inputs(n=B)
    want = jax_eval_stn(jm, variables, batches, template, 4)
    got = eval_stn(_port(pm, variables), batches, torch.from_numpy(template), 4)
    assert set(got) == set(want) == {"val_tot_score", "val_ce_score", "val_mse_score"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_hubconf_constructors():
    """The counterpart of the JAX package's hubconf test: the same models
    by the same names and keywords."""
    m = hubconf.unet(mask_classes=4)
    with torch.no_grad():
        assert m.eval()(torch.zeros(1, H, W, 3)).shape == (1, H, W, 4)
    assert not m.bilinear and not jax_hub.unet(mask_classes=4).bilinear
    assert hasattr(m, "up1") and hasattr(m.up1, "up")       # deconv: K3
    assert hubconf.unet(bilinear=True).bilinear
    r = hubconf.reconstructor(target_size=(W, H), unet_size=(W, H), warp_size=(W, H),
                              resnet_name="resnet18")
    assert r.config == type(r.config)(target_size=(W, H), unet_size=(W, H),
                                      warp_size=(W, H), resnet_name="resnet18")
    assert r.config.resnet_name == "resnet18"
    assert jax_hub.reconstructor(resnet_name="resnet18").config.resnet_name == "resnet18"
