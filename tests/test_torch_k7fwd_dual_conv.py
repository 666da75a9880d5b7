"""K7-fwd (train BN+ReLU stats and normalize), K2's two-input form, the
two-input DoubleConv built on them and the bilinear 2x up-sampling,
against the JAX package (CPU, float32).

The port runs its plain PyTorch versions (CPU tensors); the JAX side runs
its Pallas kernels in interpret mode (``interpret=True``), as
``tests/test_torch_train_kernels.py`` does.  Inputs come from a numpy
seed.  Tolerances: ``tests/test_bn_pallas.py``'s for BN+ReLU (mean 1e-6,
var 1e-5, y 2e-5; dx 1e-5, dgamma and dbeta 5e-4); 1e-5 where both sides
sum the same f32 products in another order and 1e-4 for sums over all
pixels (K2); ``tests/test_double_conv.py``'s 2e-4 (forward, stats) and
5e-4 (gradients) for the DoubleConv, on the concat and in the JAX
``dual_packed`` io; 1e-6 for the up-sampling, whose lerps both sides
compute in f32.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sports_field_homography_tpu.ops import bn_pallas
from sports_field_homography_tpu.ops import double_conv as jax_dc
from sports_field_homography_tpu.ops.conv3x3_pallas import conv3x3 as jax_conv3x3
from sports_field_homography_tpu.ops.conv3x3_pallas import (pack_pairs, pack_weights,
                                                            unpack_pairs)
from sports_field_homography_tpu.ops.resize import upsample2x_bilinear as jax_upsample
from sports_field_homography_tpu_torch.ops.bn_relu import (bn_relu_norm, bn_relu_stats,
                                                           bn_relu_train, finalize_stats)
from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain
from sports_field_homography_tpu_torch.ops.double_conv import (double_conv_eval,
                                                               double_conv_train)
from sports_field_homography_tpu_torch.ops.resize import upsample2x_bilinear

EPS = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _bn_data(c, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(3, 8, 16, c).astype(np.float32),
            (rng.rand(c) + 0.5).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32))


@pytest.mark.parametrize("c", [64, 128])
def test_bn_relu_train_forward_matches_pallas(c):
    x, g, b = _bn_data(c, c)
    y_j, m_j, v_j = bn_pallas.bn_relu_train(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                                            EPS, True)
    y, mean, var = bn_relu_train(_t(x), _t(g), _t(b), EPS)
    np.testing.assert_allclose(mean.numpy(), np.asarray(m_j), atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(v_j), atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=2e-5)
    assert y.dtype == torch.float32 and not mean.requires_grad


def test_bn_relu_stats_and_norm_compose_the_train_forward():
    """The Function is stats -> finalize -> norm; the two pieces on their
    own give the same tensors bit for bit."""
    x, g, b = _bn_data(64, 3)
    y, mean, var = bn_relu_train(_t(x), _t(g), _t(b), EPS)
    s = bn_relu_stats(_t(x))
    assert s.shape == (2, 64) and s.dtype == torch.float32
    np.testing.assert_allclose(s.numpy(), np.stack([x.sum((0, 1, 2)), (x * x).sum((0, 1, 2))]),
                               rtol=1e-5, atol=1e-3)
    m2, v2, rstd = finalize_stats(s, 3 * 8 * 16, EPS)
    assert torch.equal(m2, mean) and torch.equal(v2, var)
    assert torch.equal(bn_relu_norm(_t(x), mean, rstd * _t(g), _t(b)), y)


def test_bn_relu_norm_rounds_once_to_bf16():
    x, g, b = _bn_data(64, 4)
    xb = _t(x).bfloat16()
    mean, inv = _t(x.mean((0, 1, 2))), _t(g)
    got = bn_relu_norm(xb, mean, inv, _t(b))
    assert got.dtype == torch.bfloat16
    want = torch.relu((xb.float() - mean) * inv + _t(b)).bfloat16()
    assert torch.equal(got, want)


def test_bn_relu_train_gradients_match_pallas():
    x, g, b = _bn_data(64, 0)

    def loss_j(x, g, b):
        y, _, _ = bn_pallas.bn_relu_train(x, g, b, EPS, True)
        return jnp.sum(y.astype(jnp.float32) ** 2)

    want = jax.grad(loss_j, argnums=(0, 1, 2))(*map(jnp.asarray, (x, g, b)))
    tx, tg, tb = (_t(a).requires_grad_() for a in (x, g, b))
    y, _, _ = bn_relu_train(tx, tg, tb, EPS)
    (y ** 2).sum().backward()
    for got, w, tol, tag in zip((tx.grad, tg.grad, tb.grad), want, (1e-5, 5e-4, 5e-4),
                                ("dx", "dgamma", "dbeta")):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=tol, err_msg=tag)


def _prologue(rng, c):
    return (rng.standard_normal(c).astype(np.float32) * 0.1,
            rng.uniform(0.5, 1.5, c).astype(np.float32),
            rng.standard_normal(c).astype(np.float32) * 0.1)


@pytest.mark.parametrize("ca,cb,prologue,stats", [(64, 64, False, True), (64, 64, True, False),
                                                  (48, 80, True, True)])
def test_conv3x3_two_inputs_match_pallas(ca, cb, prologue, stats):
    rng = np.random.default_rng(70 + ca + cb)
    a = rng.standard_normal((2, 8, 16, ca)).astype(np.float32)
    b = rng.standard_normal((2, 8, 16, cb)).astype(np.float32)
    wa = (rng.standard_normal((3, 3, ca, 64)) / np.sqrt(9 * (ca + cb))).astype(np.float32)
    wb = (rng.standard_normal((3, 3, cb, 64)) / np.sqrt(9 * (ca + cb))).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32) * 0.1
    pro = _prologue(rng, ca) if prologue else None
    want = jax_conv3x3(jnp.asarray(a), pack_weights(jnp.asarray(wa)), jnp.asarray(bias),
                       prologue=None if pro is None else tuple(map(jnp.asarray, pro)),
                       stats=stats, interpret=True, x2=jnp.asarray(b),
                       wmat2=pack_weights(jnp.asarray(wb)))
    got = conv3x3(_t(a), _t(wa), _t(bias), None if pro is None else tuple(map(_t, pro)),
                  stats=stats, x2=_t(b), w2=_t(wb))
    if not stats:
        want, got = (want, None), (got, None)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    if stats:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4, atol=1e-4)
    # the plain version is the one-input conv of the concat, prologue on x only
    xa = _t(a) if pro is None else torch.relu((_t(a) - _t(pro[0])) * _t(pro[1]) + _t(pro[2]))
    one = conv3x3_plain(torch.cat([xa, _t(b)], -1), torch.cat([_t(wa), _t(wb)], 2), _t(bias),
                        stats=stats)
    torch.testing.assert_close(got[0], one if not stats else one[0], rtol=0, atol=0)


def test_conv3x3_two_inputs_refuse_mismatched_shapes():
    x = torch.rand(1, 4, 4, 8)
    with pytest.raises(ValueError, match="come together"):
        conv3x3(x, torch.rand(3, 3, 8, 4), x2=x)
    with pytest.raises(ValueError, match="must share"):
        conv3x3(x, torch.rand(3, 3, 8, 4), x2=torch.rand(1, 5, 4, 2), w2=torch.rand(3, 3, 2, 4))


def _dc_params(rng, cin, mid, cout):
    return [(rng.standard_normal((3, 3, cin, mid)) * 0.2).astype(np.float32),
            (rng.standard_normal(mid) * 0.1).astype(np.float32),
            (1.0 + 0.2 * rng.standard_normal(mid)).astype(np.float32),
            (rng.standard_normal(mid) * 0.1).astype(np.float32),
            (rng.standard_normal((3, 3, mid, cout)) * 0.2).astype(np.float32),
            (rng.standard_normal(cout) * 0.1).astype(np.float32),
            (1.0 + 0.2 * rng.standard_normal(cout)).astype(np.float32),
            (rng.standard_normal(cout) * 0.1).astype(np.float32)]


_GRAD_NAMES = ["dskip", "dup", "dk1", "db1", "dg1", "dbe1", "dk2", "db2", "dg2", "dbe2"]


@pytest.mark.parametrize("c,mid,cout", [(64, 64, 64), (128, 128, 64)])
def test_double_conv_two_inputs_match_jax(c, mid, cout):
    """The port's two-input DoubleConv Function against the JAX
    ``double_conv_train`` on the concat [skip, up] (native io) and, at the
    64 + 64 -> 64 level-1 shape, in its concat-free ``dual_packed`` io:
    output and stats at 2e-4, all ten gradients at 5e-4."""
    rng = np.random.default_rng(80 + c + mid)
    a = rng.standard_normal((2, 8, 16, c)).astype(np.float32)
    b = rng.standard_normal((2, 8, 16, c)).astype(np.float32)
    params = _dc_params(rng, 2 * c, mid, cout)
    cot = rng.standard_normal((2, 8, 16, cout)).astype(np.float32)
    jp = [jnp.asarray(p) for p in params]
    ja, jb, jcot = jnp.asarray(a), jnp.asarray(b), jnp.asarray(cot)

    def native(a, b, *p):
        return jax_dc.double_conv_train(jnp.concatenate([a, b], -1), *p, EPS, True)

    def dual(a, b, *p):
        out, *stats = jax_dc.double_conv_train((pack_pairs(a), pack_pairs(b)), *p, EPS, True,
                                               "dual_packed")
        return (unpack_pairs(out), *stats)

    refs = [native] + ([dual] if (c, mid, cout) == (64, 64, 64) else [])
    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    tp = [_t(p).requires_grad_() for p in params]
    got = double_conv_train(ta, *tp, EPS, x2=tb)
    assert not any(s.requires_grad for s in got[1:])
    (got[0] * _t(cot)).sum().backward()
    grads = [ta.grad, tb.grad] + [p.grad for p in tp]
    for ref in refs:
        want = ref(ja, jb, *jp)
        for g, w, tag in zip(got, want, ("out", "mean1", "var1", "mean2", "var2")):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=2e-4, atol=2e-4,
                                       err_msg=f"{ref.__name__} {tag}")
        want_g = jax.grad(lambda *args: jnp.sum(ref(*args)[0] * jcot),
                          argnums=tuple(range(10)))(ja, jb, *jp)
        for g, w, tag in zip(grads, want_g, _GRAD_NAMES):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4, atol=5e-4,
                                       err_msg=f"{ref.__name__} {tag}")


def test_double_conv_eval_two_inputs_match_jax():
    """Eval (running stats): the port's two-input form against the JAX
    ``double_conv_eval`` on the concat and in ``dual_packed`` io, 2e-4."""
    rng = np.random.default_rng(90)
    a = rng.standard_normal((2, 8, 16, 64)).astype(np.float32)
    b = rng.standard_normal((2, 8, 16, 64)).astype(np.float32)
    k1, b1, g1, be1, k2, b2, g2, be2 = _dc_params(rng, 128, 64, 64)
    rm1, rm2 = (rng.standard_normal(64).astype(np.float32) * 0.2 for _ in range(2))
    rv1, rv2 = (1 + rng.random(64).astype(np.float32) for _ in range(2))
    args = [k1, b1, g1, be1, rm1, rv1, k2, b2, g2, be2, rm2, rv2]
    jargs = [jnp.asarray(v) for v in args]
    want = jax_dc.double_conv_eval(jnp.concatenate([jnp.asarray(a), jnp.asarray(b)], -1),
                                   *jargs, EPS, True)
    want_p = unpack_pairs(jax_dc.double_conv_eval((pack_pairs(jnp.asarray(a)),
                                                   pack_pairs(jnp.asarray(b))),
                                                  *jargs, EPS, True, "dual_packed"))
    got = double_conv_eval(_t(a), *map(_t, args), EPS, x2=_t(b))
    for w in (want, want_p):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape", [(2, 5, 7, 8), (1, 22, 40, 3), (2, 1, 1, 4)])
def test_upsample2x_bilinear_matches_jax(shape):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    got = upsample2x_bilinear(_t(x))
    want = np.asarray(jax_upsample(jnp.asarray(x)))
    assert got.shape == want.shape == (shape[0], 2 * shape[1], 2 * shape[2], shape[3])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
