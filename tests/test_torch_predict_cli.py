"""Both predict CLIs on the same frames and weights (CPU, float32).

Four tiny PNG frames and a ``conf.yaml`` sidecar as in
``tests/test_predict_cli.py``; the weights are made from a numpy seed,
saved as the JAX package's ``.msgpack`` (read by the JAX CLI) and as a
reference-keyed ``.pth`` through ``save_torch_checkpoint`` (read by the
port).  The two ``{game}_court.json`` files must agree: theta max-abs
2e-4, score 1e-3 plus the JSON's rounding.
"""
import json
import os

import numpy as np
import pytest
import yaml
from PIL import Image

import jax
import jax.numpy as jnp

from sports_field_homography_tpu.cli.predict import process as jax_process
from sports_field_homography_tpu.compat.torch_export import save_torch_checkpoint
from sports_field_homography_tpu.data.assets import open_court_poi, open_court_template
from sports_field_homography_tpu.models import Reconstructor, ReconstructorConfig
from sports_field_homography_tpu.utils.checkpoint import save_checkpoint
from sports_field_homography_tpu_torch.cli.predict import process as port_process

W, H = 64, 36
ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "assets")
COURT = os.path.join(ASSETS, "mask_ncaa_v4_nc4_m_onehot.png")
POI = os.path.join(ASSETS, "template_ncaa_v4_points.json")


def _seeded_variables(seed):
    """resnet18 img+mask Reconstructor variables from a numpy seed."""
    cfg = ReconstructorConfig(target_size=(W, H), unet_size=(W, H),
                              warp_size=(W, H), resnet_name="resnet18")
    model = Reconstructor(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
        open_court_template(COURT, 4, size=(W, H)), open_court_poi(POI, 1),
        train=False))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        keys = [p.key for p in path]
        if "reg" in keys:
            scale = 0.02 if keys[-1] == "kernel" else 0.01
            base = np.eye(3).ravel() if keys[-1] == "bias" else 0.0
            return (base + rng.standard_normal(leaf.shape) * scale).astype(np.float32)
        if keys[-1] == "kernel":
            std = np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) * std).astype(np.float32)
        if keys[-1] in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_predict")
    img_dir = root / "game1"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(
            img_dir / f"{i:06d}.png")
    cp_dir = root / "ckpt" / "model_v2"
    cp_dir.mkdir(parents=True)
    conf = {"target_size": [W, H], "unet_size": [W, H], "warp_size": [W, H],
            "court_size": [W, H], "mask_classes": 4, "resnet_name": "resnet18",
            "resnet_input": "img+mask", "use_unet": True, "use_resnet": True}
    with open(cp_dir / "conf.yaml", "w") as f:
        yaml.safe_dump(conf, f)
    variables = _seeded_variables(0)
    save_checkpoint(str(cp_dir / "CP_epoch1.msgpack"), variables)
    save_torch_checkpoint(str(cp_dir / "CP_epoch1.pth"), variables)
    return root, img_dir, cp_dir


def _argv(img_dir, ckpt, dst):
    # --out_size 128 72 raises warp_size/court_size above the 64x36 logits,
    # so the consistency labels come from the subsampled warp grid
    return ["--img_dir", str(img_dir), "--load", str(ckpt), "--dst_dir", str(dst),
            "--req_outputs", "theta,consistency", "--out_size", "128", "72",
            "--batchsize", "3", "--compute_dtype", "float32",
            "--court_img", COURT, "--court_poi", POI]


def test_port_cli_matches_jax_cli(workspace, tmp_path):
    root, img_dir, cp_dir = workspace
    jax_process(_argv(img_dir, cp_dir / "CP_epoch1.msgpack", tmp_path / "jax"))
    stats = port_process(_argv(img_dir, cp_dir / "CP_epoch1.pth", tmp_path / "port")
                         + ["--device", "cpu"])
    assert stats["frames"] == 4
    want = json.load(open(tmp_path / "jax" / "game1_court.json"))
    got = json.load(open(tmp_path / "port" / "game1_court.json"))
    assert got["model"] == want["model"] == "model_v2"
    assert set(got) == set(want) and len(got) == 5
    thetas = []
    for name in sorted(k for k in want if k != "model"):
        assert list(got[name]) == ["score", "theta"]
        np.testing.assert_allclose(got[name]["theta"], want[name]["theta"],
                                   rtol=0, atol=2e-4)
        assert abs(got[name]["score"] - want[name]["score"]) <= 1e-3 + 1e-6
        thetas.append(np.asarray(got[name]["theta"]))
    assert np.asarray(thetas).shape == (4, 1, 3, 3)
    assert np.ptp(np.asarray(thetas), axis=0).max() > 1e-3     # frames differ


@pytest.mark.parametrize("extra,match", [
    (["--num_hosts", "2"], "multi-device"),
    (["--coordinator", "localhost:1234"], "multi-device"),
    (["--req_outputs", "theta,segm_mask", "--mask_type", "foo"], "mask_type foo"),
    (["--num_devices", "2"], "multi-device"),
])
def test_port_cli_names_unported_flags(workspace, tmp_path, extra, match):
    """An unported option is refused by name.  Multi-device predict is
    ported (``tests/test_torch_predict_multihost.py``): its flags are
    refused, before any model is built, only where they are incomplete
    (a host count or a coordinator alone) or ask for more cards than the
    machine has (``--num_devices 2`` on CUDA here)."""
    root, img_dir, cp_dir = workspace
    device = "cuda" if "--num_devices" in extra else "cpu"
    argv = _argv(img_dir, cp_dir / "CP_epoch1.pth", tmp_path) + ["--device", device]
    refused = NotImplementedError if match != "multi-device" else (ValueError, SystemExit)
    with pytest.raises(refused, match=match):
        port_process(argv + extra)


def test_port_cli_rejects_msgpack(workspace, tmp_path):
    """The port reads the JAX package's .msgpack itself now
    (``tests/test_torch_flax_msgpack.py``): a torn one is rejected by the
    reader, and an orbax directory with the script that converts it."""
    root, img_dir, cp_dir = workspace
    torn = tmp_path / "ckpt" / "CP_epoch1.msgpack"
    torn.parent.mkdir()
    torn.write_bytes((cp_dir / "CP_epoch1.msgpack").read_bytes()[:-100])
    argv = _argv(img_dir, torn, tmp_path / "out") + ["--device", "cpu"]
    with pytest.raises(ValueError, match="msgpack: truncated"):
        port_process(argv)
    argv = _argv(img_dir, cp_dir / "CP_epoch1.orbax", tmp_path / "out") + ["--device", "cpu"]
    with pytest.raises(NotImplementedError, match="export_torch_checkpoint"):
        port_process(argv)
