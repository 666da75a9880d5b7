"""The port's ResNet family against the JAX package (CPU, float32).

resnet50, resnext50_32x4d and wide_resnet50_2 (the bottleneck block, with
groups and a wider bottleneck) run the STN forward on the JAX package's
seeded weights, carried by ``compat/jax_params.state_dict_from_jax``, in
eval and in train mode: theta within 2e-4 max-abs (``docs/PARITY.md``).
The deeper variants and the reference's ``resnet52`` alias are checked in
structure: the port's ``state_dict`` names and shapes equal the JAX
package's reference-keyed export (``compat/torch_export``) of the same
variant, which loads with ``strict=True``.  A reference-keyed Bottleneck
Reconstructor state_dict loads strictly, and BN folding keeps theta.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sports_field_homography_tpu.compat.torch_export import export_state_dict
from sports_field_homography_tpu.models.resnet import resnet_stn
from sports_field_homography_tpu_torch.compat.jax_params import state_dict_from_jax
from sports_field_homography_tpu_torch.models.resnet import ResNetSTN, resnet_models

W, H, B, CIN = 64, 36, 3, 7


def _port(name, variables):
    model = ResNetSTN(in_channels=CIN, **resnet_models[name])
    sd = {k[len("resnet_reg."):]: v for k, v in state_dict_from_jax(
        {"params": {"resnet_reg": variables["params"]},
         "batch_stats": {"resnet_reg": variables["batch_stats"]}}).items()}
    model.load_state_dict(sd, strict=True)
    return model


@pytest.mark.parametrize("name", ["resnet50", "resnext50_32x4d", "wide_resnet50_2"])
def test_bottleneck_stn_matches_jax(name):
    rng = np.random.default_rng(11)
    x = rng.random((B, H, W, CIN), dtype=np.float32)
    model = resnet_stn(name)
    variables = jax.device_get(model.init(jax.random.PRNGKey(1), jnp.zeros((1, H, W, CIN))))
    # a nonzero head, so that theta depends on the backbone
    reg = variables["params"]["reg"]
    reg["kernel"] = (rng.standard_normal(reg["kernel"].shape) * 0.05).astype(np.float32)
    # non-trivial running statistics, so that eval mode reads them
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "var"
                         else rng.normal(0.0, 0.1, a.shape)).astype(np.float32),
        variables["batch_stats"])
    # theta is linear in the head's kernel: scale it so that theta moves
    # ~0.1 from the identity (eval BN on these statistics grows activations)
    dev = np.abs(np.asarray(model.apply(variables, x, train=False)).reshape(B, 9)
                 - np.eye(3).ravel()).max()
    reg["kernel"] = (reg["kernel"] * (0.1 / dev)).astype(np.float32)
    port = _port(name, variables)

    want = np.asarray(model.apply(variables, x, train=False))
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, 1, 3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    assert np.ptp(want, axis=0).max() > 1e-3           # samples differ

    if name != "resnet50":
        return
    # train mode (batch moments, running-stat update) once, on resnet50
    want_t, upd = model.apply(variables, x, train=True, mutable=["batch_stats"])
    port.train()
    with torch.no_grad():
        got_t = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_t, np.asarray(want_t), rtol=0, atol=2e-4)
    new = state_dict_from_jax({"params": {"resnet_reg": variables["params"]},
                               "batch_stats": {"resnet_reg": jax.device_get(upd["batch_stats"])}})
    ours = port.state_dict()
    for k in ("layer1.0.bn3.running_mean", "layer4.2.bn2.running_var",
              "layer2.0.downsample.1.running_var"):
        np.testing.assert_allclose(ours[k].numpy(), new["resnet_reg." + k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["resnet101", "resnet152", "resnet52", "resnext101_32x8d",
                                  "wide_resnet101_2"])
def test_deep_variants_have_the_jax_export_structure(name):
    """Names and shapes only: the JAX weights' shapes come from
    ``jax.eval_shape``, exported through zero-stride stand-ins, and the
    port's module is built on the meta device, so no weight is allocated;
    tensors of the export's names and shapes load strictly by assignment."""
    shapes = jax.eval_shape(resnet_stn(name).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, CIN)))
    stand_in = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    want = export_state_dict({"params": {"resnet_reg": stand_in["params"]},
                              "batch_stats": {"resnet_reg": stand_in["batch_stats"]}})
    with torch.device("meta"):
        port = ResNetSTN(in_channels=CIN, **resnet_models[name])
    ours = {"resnet_reg." + k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert ours == {k: tuple(v.shape) for k, v in want.items()}
    port.load_state_dict({k[len("resnet_reg."):]: torch.empty(v.shape, device="meta")
                          for k, v in want.items()}, strict=True, assign=True)
    if name == "resnet52":
        assert resnet_models["resnet52"] == resnet_models["resnet152"]
    n_blocks = sum(len(getattr(port, f"layer{i}")) for i in range(1, 5))
    assert n_blocks == sum(resnet_models[name]["layers"])


def test_reference_keyed_bottleneck_reconstructor_loads_strictly():
    """A whole Reconstructor with a resnet50 STN: the names and shapes of
    the JAX package's reference-keyed export (``resnet_reg.layerN.i.conv3``,
    ``downsample.*``; shapes from ``jax.eval_shape``) load strictly into
    the port's, and folding its BN keeps theta."""
    from sports_field_homography_tpu.models import Reconstructor as JaxReconstructor
    from sports_field_homography_tpu.models import ReconstructorConfig as JaxConfig
    from sports_field_homography_tpu_torch.models import Reconstructor, ReconstructorConfig
    from sports_field_homography_tpu_torch.models.layers import init_weights
    from sports_field_homography_tpu_torch.ops.fold_bn import fold_batchnorm

    kw = dict(target_size=(W, H), unet_size=(W, H), warp_size=(W, H),
              resnet_name="resnet50", resnet_input="img+mask")
    jm = JaxReconstructor(JaxConfig(**kw))
    shapes = jax.eval_shape(lambda key: jm.init(key, jnp.zeros((1, H, W, 3)),
                                                jnp.zeros((1, H, W, 1)), jnp.zeros((1, 52, 2)),
                                                train=False), jax.random.PRNGKey(0))
    want = export_state_dict(jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes))
    assert "resnet_reg.layer3.5.conv3.weight" in want
    assert "resnet_reg.layer1.0.downsample.0.weight" in want
    with torch.device("meta"):
        meta = Reconstructor(ReconstructorConfig(**kw))
    meta.load_state_dict({k: torch.empty(v.shape, device="meta", dtype=torch.float32)
                          for k, v in want.items()}, strict=True, assign=True)

    model = init_weights(Reconstructor(ReconstructorConfig(**kw)), torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.resnet_reg.reg.weight.normal_(0.0, 0.01)
    model.eval()
    x = torch.from_numpy(np.random.default_rng(3).random((2, H, W, 3), dtype=np.float32))
    with torch.no_grad():
        before = model.predict(x, consistency=False)["theta"]
        fold_batchnorm(model)
        after = model.predict(x, consistency=False)["theta"]
    assert before.std(0).max() > 1e-4
    np.testing.assert_allclose(after.numpy(), before.numpy(), rtol=0, atol=2e-5)
