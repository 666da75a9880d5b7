"""The training kernels' modules against the JAX package (CPU, float32):
K2 with its stats epilogue, K5 (wgrad), K7-bwd (BN+ReLU backward), K3 and
K3-bwd (deconv), and the DoubleConv autograd Function built on them.

The port runs its plain PyTorch versions (CPU tensors); the JAX side runs
its Pallas kernels in interpret mode (``interpret=True``), and XLA for the
3-channel stem, as ``tests/test_double_conv.py`` does.  Inputs come from a
numpy seed.  Tolerances: 1e-5 (rtol and atol) where both sides sum the
same f32 products in another order, 1e-4 for sums over all pixels, and
the JAX tests' own 2e-4 (forward, stats) and 5e-4 (gradients) for the
DoubleConv.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sports_field_homography_tpu.ops import double_conv as jax_dc
from sports_field_homography_tpu.ops.conv3x3_pallas import conv3x3 as jax_conv3x3
from sports_field_homography_tpu.ops.conv3x3_pallas import pack_weights
from sports_field_homography_tpu.ops.conv3x3_pallas import wgrad3x3 as jax_wgrad3x3
from sports_field_homography_tpu.ops.deconv_pallas import deconv2x2_packed
from sports_field_homography_tpu_torch.models.unet import DoubleConv
from sports_field_homography_tpu_torch.ops.bn_relu_bwd import bn_relu_bwd
from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3, dgrad_weights
from sports_field_homography_tpu_torch.ops.deconv import deconv2x2, deconv2x2_backward
from sports_field_homography_tpu_torch.ops.double_conv import double_conv_train
from sports_field_homography_tpu_torch.ops.wgrad3x3 import wgrad3x3

EPS = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _prologue(rng, c):
    return (rng.standard_normal(c).astype(np.float32) * 0.1,
            rng.uniform(0.5, 1.5, c).astype(np.float32),
            rng.standard_normal(c).astype(np.float32) * 0.1)


@pytest.mark.parametrize("cin,prologue", [(64, False), (64, True), (3, False)])
def test_conv3x3_stats_matches_pallas(cin, prologue):
    rng = np.random.default_rng(10 + cin)
    x = rng.standard_normal((2, 8, 16, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, 64)) / np.sqrt(9 * cin)).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32) * 0.1
    pro = _prologue(rng, cin) if prologue else None
    y_j, s_j = jax_conv3x3(
        jnp.asarray(x), pack_weights(jnp.asarray(k)), jnp.asarray(b),
        prologue=None if pro is None else tuple(map(jnp.asarray, pro)),
        stats=True, interpret=True)
    y, s = conv3x3(_t(x), _t(k), _t(b), None if pro is None else tuple(map(_t, pro)),
                   stats=True)
    assert s.shape == (2, 64) and s.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=1e-4, atol=1e-4)


def test_conv3x3_stats_sum_before_rounding():
    """bf16: the sums are those of the f32 result, not of its bf16 copy."""
    rng = np.random.default_rng(7)
    x = _t(rng.standard_normal((2, 8, 16, 64)).astype(np.float32)).bfloat16()
    k = _t(rng.standard_normal((3, 3, 64, 64)).astype(np.float32) / 24)
    b = _t(rng.standard_normal(64).astype(np.float32))
    y, s = conv3x3(x, k, b, stats=True)
    yf = conv3x3(x.float(), k.bfloat16().float(), b)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(s[0], yf.sum(dim=(0, 1, 2)), rtol=1e-5, atol=1e-3)
    assert not torch.equal(s[0], y.float().sum(dim=(0, 1, 2)))


def test_dgrad_weights_give_the_input_gradient():
    rng = np.random.default_rng(8)
    x = _t(rng.standard_normal((2, 8, 16, 32)).astype(np.float32)).requires_grad_()
    k = _t(rng.standard_normal((3, 3, 32, 48)).astype(np.float32) / 17)
    g = _t(rng.standard_normal((2, 8, 16, 48)).astype(np.float32))
    y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                                   padding=1).permute(0, 2, 3, 1)
    (want,) = torch.autograd.grad(y, x, g)
    np.testing.assert_allclose(conv3x3(g, dgrad_weights(k)).numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin,cout,prologue", [(64, 64, False), (64, 64, True),
                                               (128, 32, True), (3, 64, False)])
def test_wgrad3x3_matches_pallas(cin, cout, prologue):
    rng = np.random.default_rng(20 + cin + cout)
    x = rng.standard_normal((2, 8, 16, cin)).astype(np.float32)
    dy = rng.standard_normal((2, 8, 16, cout)).astype(np.float32)
    pro = _prologue(rng, cin) if prologue else None
    dw_j, db_j = jax_wgrad3x3(
        jnp.asarray(x), jnp.asarray(dy),
        prologue=None if pro is None else tuple(map(jnp.asarray, pro)),
        interpret=True)
    dw, db = wgrad3x3(_t(x), _t(dy), None if pro is None else tuple(map(_t, pro)))
    assert dw.shape == (3, 3, cin, cout) and dw.dtype == torch.float32
    np.testing.assert_allclose(dw.reshape(9 * cin, cout).numpy(), np.asarray(dw_j),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_j), rtol=1e-5, atol=1e-4)


def test_bn_relu_bwd_matches_pallas():
    """At a 128-wide lane dim, where the JAX package runs its kernels."""
    rng = np.random.default_rng(30)
    c = 128
    y = (rng.standard_normal((2, 8, 16, c)) * 2 + 0.3).astype(np.float32)
    g = rng.standard_normal((2, 8, 16, c)).astype(np.float32)
    mean = y.mean(axis=(0, 1, 2))
    var = (y * y).mean(axis=(0, 1, 2)) - mean * mean
    rstd = (1.0 / np.sqrt(var + EPS)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.3).astype(np.float32)
    m = 2 * 8 * 16
    want = jax_dc._bn_relu_bwd(*map(jnp.asarray, (y, g, mean, rstd, gamma, beta)),
                               m, interpret=True)
    got = bn_relu_bwd(*map(_t, (y, g, mean, rstd, gamma, beta)))
    for a, b, tag in zip(got, want, ("dy", "dgamma", "dbeta")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4,
                                   err_msg=tag)


@pytest.mark.parametrize("cin,cout", [(128, 64), (64, 32)])
def test_deconv_forward_and_backward_match_pallas(cin, cout):
    rng = np.random.default_rng(40 + cin)
    x = rng.standard_normal((2, 8, 16, cin)).astype(np.float32)
    k = (rng.standard_normal((cin, 2, 2, cout)) / np.sqrt(cin)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32) * 0.1
    g = rng.standard_normal((2, 16, 32, cout)).astype(np.float32)

    def f(xx, kk, bb):
        return deconv2x2_packed(xx, kk, bb, True, True)

    y_j, vjp = jax.vjp(f, *map(jnp.asarray, (x, k, b)))
    dx_j, dk_j, db_j = vjp(jnp.asarray(g))

    xt, kt, bt = (_t(a).requires_grad_() for a in (x, k, b))
    y = deconv2x2(xt, kt, bt)
    y.backward(_t(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    for got, want, tag in ((xt.grad, dx_j, "dx"), (kt.grad, dk_j, "dW"),
                           (bt.grad, db_j, "db")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4, err_msg=tag)
    direct = deconv2x2_backward(_t(x), _t(g), _t(k))
    for got, want in zip(direct, (xt.grad, kt.grad, bt.grad)):
        torch.testing.assert_close(got, want)


def _dc_params(rng, cin, mid, cout):
    return [(rng.standard_normal((3, 3, cin, mid)) * 0.2).astype(np.float32),
            (rng.standard_normal(mid) * 0.1).astype(np.float32),
            (1.0 + 0.2 * rng.standard_normal(mid)).astype(np.float32),
            (rng.standard_normal(mid) * 0.1).astype(np.float32),
            (rng.standard_normal((3, 3, mid, cout)) * 0.2).astype(np.float32),
            (rng.standard_normal(cout) * 0.1).astype(np.float32),
            (1.0 + 0.2 * rng.standard_normal(cout)).astype(np.float32),
            (rng.standard_normal(cout) * 0.1).astype(np.float32)]


@pytest.mark.parametrize("cin,mid", [(64, 64), (3, 64), (64, 128)])
def test_double_conv_function_matches_jax(cin, mid):
    """Outputs and stats at 2e-4, all nine gradients at 5e-4."""
    rng = np.random.default_rng(50 + cin + mid)
    x = rng.standard_normal((2, 8, 16, cin)).astype(np.float32)
    params = _dc_params(rng, cin, mid, 64)
    cot = rng.standard_normal((2, 8, 16, 64)).astype(np.float32)

    jx = [jnp.asarray(a) for a in [x] + params]
    want = jax_dc.double_conv_train(*jx, EPS, True)

    def loss(*a):
        return jnp.sum(jax_dc.double_conv_train(*a, EPS, True)[0] * jnp.asarray(cot))

    want_grads = jax.grad(loss, argnums=tuple(range(9)))(*jx)

    tx = [_t(a).requires_grad_() for a in [x] + params]
    got = double_conv_train(*tx, EPS)
    for a, b, tag in zip(got, want, ("out", "mean1", "var1", "mean2", "var2")):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-4, err_msg=tag)
    assert not any(s.requires_grad for s in got[1:])
    (got[0] * _t(cot)).sum().backward()
    names = ["dx", "dk1", "db1", "dg1", "dbe1", "dk2", "db2", "dg2", "dbe2"]
    for t, w, tag in zip(tx, want_grads, names):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=5e-4,
                                   atol=5e-4, err_msg=tag)


@pytest.mark.parametrize("cin", [64, 3])
def test_double_conv_module_train_matches_jax_pallas_path(cin, monkeypatch):
    """The port's DoubleConv module in training mode against the JAX
    module on its fused Pallas path (the pixel gate lowered for the small
    shape): output, updated running stats, parameter gradients."""
    from sports_field_homography_tpu.models.unet import DoubleConv as JaxDoubleConv
    from sports_field_homography_tpu_torch.compat.jax_params import _double_conv

    monkeypatch.setattr(jax_dc, "_TRAIN_MIN_PIXELS", 0)
    rng = np.random.default_rng(60 + cin)
    x = rng.standard_normal((2, 8, 16, cin)).astype(np.float32)
    cot = rng.standard_normal((2, 8, 16, 64)).astype(np.float32)
    mod = JaxDoubleConv(64, conv_kernel="pallas")
    variables = jax.tree.map(   # kernels N(0, 0.2^2), vectors U(0.5, 1.5)
        lambda a: jnp.asarray((rng.standard_normal(a.shape) * 0.2 if a.ndim == 4
                               else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)),
        mod.init(jax.random.PRNGKey(0), jnp.asarray(x), True))

    def loss(params):
        out, upd = mod.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             jnp.asarray(x), True, mutable=["batch_stats"])
        return jnp.sum(out * jnp.asarray(cot)), (out, upd)

    (_, (out_j, upd_j)), grads_j = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])

    def state(tree):
        sd = {}
        _double_conv(sd, tree, (), "double_conv")
        return {k: torch.from_numpy(np.array(v, np.float32 if v.dtype != np.int64
                                               else np.int64)) for k, v in sd.items()}

    port = DoubleConv(cin, 64)
    port.load_state_dict(state(variables), strict=True)
    port.train()
    xt = _t(x)
    out = port(xt)
    (out * _t(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=2e-4,
                               atol=2e-4)
    want = state({"params": variables["params"], **upd_j})
    for k, v in port.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=2e-4,
                                       atol=2e-4, err_msg=k)
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1
    want_g = state({"params": grads_j})
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(), rtol=5e-4,
                                   atol=5e-4, err_msg=name)
