"""K2, K3 and the inference DoubleConv: the port against the JAX package
(CPU, float32).

The port runs its plain PyTorch versions (CPU tensors); the JAX side runs
the Pallas kernels in interpret mode, and its XLA path for the stem.
Tolerance rtol = atol = 1e-5: both sides sum the same f32 products in
different orders.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from sports_field_homography_tpu.ops import double_conv as jax_dc
from sports_field_homography_tpu.ops.conv3x3_pallas import conv3x3 as jax_conv3x3
from sports_field_homography_tpu.ops.conv3x3_pallas import pack_weights
from sports_field_homography_tpu.ops.deconv_pallas import deconv2x2_packed
from sports_field_homography_tpu.ops.fold_bn import fold_batchnorm as jax_fold
from sports_field_homography_tpu_torch.models.unet import DoubleConv
from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3
from sports_field_homography_tpu_torch.ops.deconv import deconv2x2
from sports_field_homography_tpu_torch.ops.double_conv import double_conv_eval
from sports_field_homography_tpu_torch.ops.fold_bn import fold_batchnorm

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("prologue", [False, True])
def test_conv3x3_matches_pallas(prologue):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 64)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 64, 64)) / 24).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32) * 0.1
    pro = None
    if prologue:
        pro = (rng.standard_normal(64).astype(np.float32) * 0.1,
               rng.uniform(0.5, 1.5, 64).astype(np.float32),
               rng.standard_normal(64).astype(np.float32) * 0.1)
    want = np.asarray(jax_conv3x3(
        jnp.asarray(x), pack_weights(jnp.asarray(k)), jnp.asarray(b),
        prologue=None if pro is None else tuple(map(jnp.asarray, pro)),
        interpret=True))
    got = conv3x3(_t(x), _t(k), _t(b),
                  None if pro is None else tuple(map(_t, pro))).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if prologue:   # the re-zeroed padding matters: relu(beta - mean*inv) != 0
        no_pad = conv3x3(_t(x), _t(k), _t(b)).numpy()
        assert np.abs(got - no_pad).max() > 1e-2


def test_deconv_matches_pallas():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 16, 128)).astype(np.float32)
    k = (rng.standard_normal((128, 2, 2, 64)) / 12).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32) * 0.1
    want = np.asarray(deconv2x2_packed(jnp.asarray(x), jnp.asarray(k),
                                       jnp.asarray(b), True, True))
    got = deconv2x2(_t(x), _t(k), _t(b)).numpy()
    assert got.shape == (2, 16, 32, 64)
    np.testing.assert_allclose(got, want, **TOL)


def test_deconv_odd_size_matches_conv_transpose2d():
    """Odd H and W (the UNet's 45x80 -> 22x40 level) against torch's own
    ConvTranspose2d on its IOHW weight."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 7, 32)).astype(np.float32)
    w_iohw = (rng.standard_normal((32, 16, 2, 2)) / 6).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    got = deconv2x2(_t(x), _t(w_iohw).permute(0, 2, 3, 1), _t(b)).numpy()
    want = F.conv_transpose2d(_t(x).permute(0, 3, 1, 2), _t(w_iohw), _t(b),
                              stride=2).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 10, 14, 16)
    np.testing.assert_allclose(got, want, **TOL)


def _double_conv_vars(rng, cin, cmid, cout):
    def conv(ci, co):
        return {"kernel": (rng.standard_normal((3, 3, ci, co))
                           / np.sqrt(9 * ci)).astype(np.float32),
                "bias": (rng.standard_normal(co) * 0.1).astype(np.float32)}

    def bn(c):
        return ({"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                 "bias": (rng.standard_normal(c) * 0.1).astype(np.float32)},
                {"mean": (rng.standard_normal(c) * 0.1).astype(np.float32),
                 "var": rng.uniform(0.5, 1.5, c).astype(np.float32)})

    (p1, s1), (p2, s2) = bn(cmid), bn(cout)
    return {"params": {"conv1": conv(cin, cmid), "bn1": p1,
                       "conv2": conv(cmid, cout), "bn2": p2},
            "batch_stats": {"bn1": s1, "bn2": s2}}


def _jax_args(v):
    p, s = v["params"], v["batch_stats"]
    return [p["conv1"]["kernel"], p["conv1"]["bias"], p["bn1"]["scale"],
            p["bn1"]["bias"], s["bn1"]["mean"], s["bn1"]["var"],
            p["conv2"]["kernel"], p["conv2"]["bias"], p["bn2"]["scale"],
            p["bn2"]["bias"], s["bn2"]["mean"], s["bn2"]["var"]]


def _port_module(v, cin, cout):
    """A port DoubleConv loaded with the JAX variables (reference keys)."""
    m = DoubleConv(cin, cout)
    p, s = v["params"], v["batch_stats"]
    sd = {}
    for i, (c, b) in ((0, ("conv1", "bn1")), (3, ("conv2", "bn2"))):
        sd[f"double_conv.{i}.weight"] = _t(p[c]["kernel"].transpose(3, 2, 0, 1))
        sd[f"double_conv.{i}.bias"] = _t(p[c]["bias"])
        sd[f"double_conv.{i + 1}.weight"] = _t(p[b]["scale"])
        sd[f"double_conv.{i + 1}.bias"] = _t(p[b]["bias"])
        sd[f"double_conv.{i + 1}.running_mean"] = _t(s[b]["mean"])
        sd[f"double_conv.{i + 1}.running_var"] = _t(s[b]["var"])
        sd[f"double_conv.{i + 1}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    m.load_state_dict(sd, strict=True)
    return m.eval()


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("cin", [64, 3])
def test_double_conv_eval_matches_jax(folded, cin):
    """64->64->64 (K2 twice) and the 3-channel stem (cuDNN, then K2),
    with BN folded into the weights on both sides or not."""
    rng = np.random.default_rng(3 + cin)
    v = _double_conv_vars(rng, cin, 64, 64)
    x = rng.uniform(0, 1, (2, 16, 16, cin)).astype(np.float32)
    m = _port_module(v, cin, 64)
    if folded:
        v = jax_fold(v)
        fold_batchnorm(m)
    want = np.asarray(jax_dc.double_conv_eval(
        jnp.asarray(x), *map(jnp.asarray, _jax_args(v)), interpret=True))
    with torch.no_grad():
        got = m(_t(x)).numpy()
        direct = double_conv_eval(_t(x), *map(_t, _jax_args(v))).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(direct, want, **TOL)
    if folded:
        bn = m.double_conv[1]
        assert torch.all(bn.weight == 1) and torch.all(bn.running_mean == 0)
        assert torch.all(torch.rsqrt(bn.running_var + 1e-5) == 1)
