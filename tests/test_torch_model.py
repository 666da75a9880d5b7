"""The port's Reconstructor against the JAX package's (CPU, float32).

A small spatial size (the UNet's widths are fixed), resnet18, batch 2.
The variables are made from a numpy seed, with BatchNorm statistics and a
regression head away from their identity init (so that folding and the
warp see non-trivial values); the JAX model runs them under ``jax.jit``
and the port receives them through ``state_dict_from_jax``.  Bounds (docs/PARITY.md): theta max-abs 2e-4,
logits rtol 1e-3 / atol 2e-4, consistency score 1e-3.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sports_field_homography_tpu.compat.torch_export import export_state_dict
from sports_field_homography_tpu.data.assets import open_court_poi as jax_poi
from sports_field_homography_tpu.data.assets import open_court_template as jax_template
from sports_field_homography_tpu.models import Reconstructor as JaxReconstructor
from sports_field_homography_tpu.models import ReconstructorConfig as JaxConfig
from sports_field_homography_tpu.ops.fold_bn import fold_batchnorm as jax_fold
from sports_field_homography_tpu.ops.interval_warp import build_interval_table
from sports_field_homography_tpu_torch.compat.jax_params import state_dict_from_jax
from sports_field_homography_tpu_torch.data.assets import open_court_template
from sports_field_homography_tpu_torch.models import Reconstructor, ReconstructorConfig
from sports_field_homography_tpu_torch.ops.fold_bn import fold_batchnorm
from sports_field_homography_tpu_torch.ops.warp import template_value_step

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "assets")
COURT = os.path.join(ASSETS, "mask_ncaa_v4_nc4_m_onehot.png")
POI = os.path.join(ASSETS, "template_ncaa_v4_points.json")
W, H = 64, 36
COURT_SIZE = (128, 72)


def _random_variables(model, court, poi, seed):
    """The model's variable tree (shapes from ``jax.eval_shape``, nothing
    compiled) filled from a numpy seed: He-scaled kernels, small biases,
    BN scale/bias/mean/var away from the identity, a non-zero head."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), court, poi, train=False))

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if "reg" in [p.key for p in path]:
            if name == "kernel":
                return (rng.standard_normal(shape) * 0.02).astype(np.float32)
            return (np.eye(3).ravel() + rng.standard_normal(shape) * 0.01).astype(np.float32)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)   # biases, mean

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _configs(mode, warp_size, uv=False):
    kw = dict(target_size=(W, H), unet_size=(W, H), warp_size=warp_size,
              resnet_name="resnet18", resnet_input=mode, unet_uv=uv)
    return (JaxConfig(warp_with_nearest=True, **kw), ReconstructorConfig(**kw))


@pytest.fixture(scope="module")
def setup():
    """Per (mode, uv): perturbed JAX variables; plus inputs and court."""
    court = jax_template(COURT, 4, size=COURT_SIZE)
    poi = jax_poi(POI, 1)
    cache = {}

    def variables(mode, uv=False):
        if (mode, uv) not in cache:
            jcfg, _ = _configs(mode, COURT_SIZE, uv)
            model = JaxReconstructor(jcfg, dtype=jnp.float32)
            cache[(mode, uv)] = _random_variables(model, court, poi, len(cache))
        return cache[(mode, uv)]

    x = np.random.default_rng(7).uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    labels = open_court_template(COURT, 4, size=COURT_SIZE)
    return dict(variables=variables, x=x, court=court, poi=poi,
                table=build_interval_table(court), labels=labels,
                step=template_value_step(labels, 4))


def _jit_predict(jmodel, v, s):
    fn = jax.jit(lambda v, x: jmodel.apply(
        v, x, s["court"], s["poi"], consistency=True, warp_table=s["table"],
        method=jmodel.predict))
    return fn(v, jnp.asarray(s["x"]))


def _port(cfg, variables, folded):
    model = Reconstructor(cfg)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    if folded:
        fold_batchnorm(model)
    return model.eval()


def _port_predict(model, s):
    with torch.inference_mode():
        out = model.predict(torch.from_numpy(s["x"]), torch.from_numpy(s["labels"]),
                            s["step"])
    return {k: v.numpy() for k, v in out.items()}


def _assert_close(got, want, score=True):
    np.testing.assert_allclose(got["theta"], want["theta"], rtol=0, atol=2e-4)
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-3, atol=2e-4)
    if score:
        np.testing.assert_allclose(got["consist_score"], want["consist_score"],
                                   rtol=0, atol=1e-3)


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("warp_size", [COURT_SIZE, (W, H)],
                         ids=["sample_hw", "full_grid"])
def test_predict_matches_jax(setup, folded, warp_size):
    """img+mask: theta, logits and the consistency score, with the
    consistency labels from the subsampled grid or from the full warp."""
    s = setup
    v = s["variables"]("img+mask")
    jcfg, pcfg = _configs("img+mask", warp_size)
    jmodel = JaxReconstructor(jcfg, dtype=jnp.float32)
    jv = v
    if folded:
        jv, jmodel = jax_fold(v), jmodel.clone(bn_folded=True)
    want = _jit_predict(jmodel, jv, s)
    want = {k: np.asarray(want[k]) for k in ("theta", "logits", "consist_score")}
    got = _port_predict(_port(pcfg, v, folded), s)
    assert np.abs(want["theta"][0] - want["theta"][1]).max() > 1e-3   # two homographies
    _assert_close(got, want)


@pytest.mark.parametrize("mode", ["img", "mask"])
def test_other_stn_inputs_match_jax(setup, mode):
    s = setup
    v = s["variables"](mode)
    jcfg, pcfg = _configs(mode, COURT_SIZE)
    jmodel = JaxReconstructor(jcfg, dtype=jnp.float32)
    want = _jit_predict(jmodel, v, s)
    want = {k: np.asarray(want[k]) for k in ("theta", "logits", "consist_score")}
    _assert_close(_port_predict(_port(pcfg, v, True), s), want)


def test_img_mask_uv_input_matches_jax_forward(setup):
    """img+mask+uv: the JAX predict passes no UV to the STN, so theta and
    logits are held against the JAX eval forward (``__call__``)."""
    s = setup
    v = s["variables"]("img+mask+uv", uv=True)
    jcfg, pcfg = _configs("img+mask+uv", COURT_SIZE, uv=True)
    jmodel = JaxReconstructor(jcfg, dtype=jnp.float32)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, s["court"], s["poi"],
                                             train=False))(v, jnp.asarray(s["x"]))
    want = {k: np.asarray(want[k]) for k in ("theta", "logits")}
    _assert_close(_port_predict(_port(pcfg, v, False), s), want, score=False)


def test_state_dict_from_jax_equals_export(setup):
    v = setup["variables"]("img+mask")
    ours = state_dict_from_jax(v)
    theirs = export_state_dict(v)
    assert list(ours) == list(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]))
    model = Reconstructor(_configs("img+mask", COURT_SIZE)[1])
    assert set(model.state_dict()) == set(ours)
    model.load_state_dict(ours, strict=True)
