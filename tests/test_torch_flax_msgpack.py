"""The port's reader of flax msgpack checkpoints (``compat/flax_msgpack``),
held to ``flax.serialization.msgpack_restore`` leaf by leaf, bit for bit;
and the CLIs that load ``.msgpack`` through it (CPU)."""
import json

import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

import jax
import jax.numpy as jnp

from sports_field_homography_tpu.cli.engine import build_model as jax_build_model
from sports_field_homography_tpu.compat.torch_export import (export_state_dict,
                                                             save_torch_checkpoint)
from sports_field_homography_tpu.utils.checkpoint import save_checkpoint
from sports_field_homography_tpu_torch.cli import engine
from sports_field_homography_tpu_torch.cli import test as test_cli
from sports_field_homography_tpu_torch.cli.predict import process as port_process
from sports_field_homography_tpu_torch.compat.flax_msgpack import load_msgpack, msgpack_restore
from sports_field_homography_tpu_torch.compat.jax_params import state_dict_from_jax
from sports_field_homography_tpu_torch.data.synthetic import write_synthetic_dataset
from test_torch_predict_full import make_workspace, near_identity_variables
from test_torch_predict_cli import COURT, POI, H, W


def _assert_same_tree(got, want, path="tree"):
    """Same structure; every leaf the same type, dtype, shape and bytes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype == jnp.bfloat16:
        # numpy has no bfloat16: the port's leaf is a torch.bfloat16 tensor
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == np.shape(want), path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16), err_msg=path)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


class _Args:
    batchsize = 2
    target_size = unet_size = warp_size = court_size = (W, H)
    mask_classes = 4
    use_unet = use_resnet = use_warper = True
    unet_uv = False
    resnet_input = "img+mask"
    compute_dtype = "float32"
    court_img, court_poi = COURT, POI


@pytest.mark.parametrize("variant", ["flagship", "bilinear"])
def test_reader_equals_flax_on_model_variables(variant):
    """The flagship's (UNet deconv + ResNet34) and the bilinear UNet's
    variables from the JAX ``build_model``; and the port's state_dict from
    them equals ``save_torch_checkpoint``'s."""
    class Args(_Args):
        resnet_name = "resnet34" if variant == "flagship" else "resnet18"
        unet_bilinear = variant == "bilinear"

    variables = jax_build_model(Args).variables
    data = serialization.to_bytes(variables)
    got = msgpack_restore(data)
    _assert_same_tree(got, serialization.msgpack_restore(data))
    assert set(got) == {"params", "batch_stats"}
    sd, want = state_dict_from_jax(got), export_state_dict(variables)
    assert set(sd) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v).astype(sd[k].numpy().dtype),
                                      err_msg=k)


def test_reader_equals_flax_on_every_leaf_kind(monkeypatch):
    """bf16 arrays and scalars, numpy scalars of every width, lists (stored
    as maps), empty maps, Python leaves, and chunked f32 and bf16 arrays
    (flax's MAX_CHUNK_SIZE set small)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    rng = np.random.default_rng(0)
    tree = {
        "bf16": rng.standard_normal((3, 5)).astype(jnp.bfloat16),
        "bf16_scalar": jnp.bfloat16(1.5),
        "scalars": {name: np.dtype(name).type(7) for name in
                    ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
                     "uint64", "float16", "float32", "float64", "bool")},
        "list": [np.arange(3, dtype=np.int32), {"deep": np.ones((0, 4), np.float32)}, []],
        "empty": {},
        "python": {"none": None, "t": True, "f": False, "i": -3, "big": 2 ** 63 + 5,
                   "neg": -2 ** 40, "x": 0.25, "s": "label", "b": b"\x00\x01"},
        "chunked_f32": rng.standard_normal((17, 9)).astype(np.float32),
        "chunked_bf16": rng.standard_normal((300,)).astype(jnp.bfloat16),
        "f64": rng.standard_normal((2, 2, 2)),
    }
    data = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    _assert_same_tree(msgpack_restore(data), serialization.msgpack_restore(data))


def test_reader_decodes_every_msgpack_type():
    """nil, bool, the int and float families (float32 too, which flax never
    writes), str and bin 8/16/32, array and map 16/32, ndarrays in fixext 16
    and ext 8/16/32 (an ndarray payload is never 1-8 bytes; the shorter
    fixexts are refused in ``test_reader_refuses_bad_bytes``): the same as
    msgpack with flax's ext hook."""
    tree = {
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 64 - 1,
                 -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1, -2 ** 63],
        "floats": [0.5, -1e300],
        "str": ["a" * 31, "b" * 32, "c" * 300, "d" * 70000, "é"],
        "bin": [b"x" * 10, b"y" * 300, b"z" * 70000],
        "array16": list(range(20)), "array32": list(range(70000)),
        "map16": {str(i): i for i in range(20)},
        "map32": {str(i): None for i in range(70000)},
        "bools": [True, False, None],
        "npscalar": np.uint8(7),
        "fixext16": np.arange(5, dtype=np.uint8),     # a payload of 16 bytes
        "ext8": np.arange(20, dtype=np.float32),
        "ext16": np.arange(300, dtype=np.float32),
        "ext32": np.arange(20000, dtype=np.float32),
    }
    data = serialization.msgpack_serialize(tree)
    for marker in (b"\xd8\x01", b"\xc7", b"\xc8", b"\xc9", b"\xdd", b"\xdf",
                   b"\xdb", b"\xc6"):
        assert marker in data, marker
    _assert_same_tree(msgpack_restore(data), serialization.msgpack_restore(data))
    single = msgpack.packb({"f32": 0.1, "nested": [1.5]}, use_single_float=True)
    assert msgpack_restore(single) == msgpack.unpackb(single)


def test_reader_refuses_bad_bytes(tmp_path):
    data = serialization.to_bytes({"w": np.arange(40, dtype=np.float32),
                                   "b": {"x": np.ones(3, np.float32)}})
    for cut in range(0, len(data), 7):
        with pytest.raises(ValueError):
            msgpack_restore(data[:cut])
    for bad in (data + b"\x00", b"\xc1", b"\x81\xa1k\xd4\x05\x00",
                b"\xd5\x01\x00\x00", b"\xd6\x01" + b"\x00" * 4, b"\xd7\x09" + b"\x00" * 8,
                msgpack.packb({"c": msgpack.ExtType(2, msgpack.packb((1.0, 2.0)))}),
                msgpack.packb({"a": msgpack.ExtType(1, msgpack.packb(((3,), "float32",
                                                                     b"\x00" * 8)))})):
        with pytest.raises(ValueError):
            msgpack_restore(bad)
    with pytest.raises(ValueError, match="complex"):
        msgpack_restore(serialization.to_bytes({"c": 1 + 2j}))
    (tmp_path / "garbage.msgpack").write_bytes(np.random.default_rng(0).bytes(64))
    with pytest.raises(ValueError):
        load_msgpack(str(tmp_path / "garbage.msgpack"))


def test_bf16_checkpoint_loads_exactly():
    """A bf16 checkpoint's weights reach the port's state_dict exactly
    (bf16 -> f32 is exact), as ``save_torch_checkpoint`` exports them."""
    variables = near_identity_variables(0)
    bf16 = dict(variables, params=jax.tree_util.tree_map(
        lambda v: np.asarray(v).astype(jnp.bfloat16), variables["params"]))
    got = state_dict_from_jax(msgpack_restore(serialization.to_bytes(bf16)))
    want = export_state_dict(bf16)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(v).astype(got[k].numpy().dtype), err_msg=k)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return make_workspace(tmp_path_factory.mktemp("msgpack_predict"), 4)


def test_predict_cli_msgpack_equals_pth(workspace, tmp_path):
    """The port's predict CLI on ``CP_epoch1.msgpack`` writes the same
    ``{game}_court.json``, byte for byte, as on the ``.pth`` that
    ``save_torch_checkpoint`` wrote from the same variables."""
    root, img_dir, cp_dir = workspace
    out = {}
    for ext in ("msgpack", "pth"):
        dst = tmp_path / ext
        port_process(["--img_dir", str(img_dir), "--load", str(cp_dir / f"CP_epoch1.{ext}"),
                      "--dst_dir", str(dst), "--req_outputs", "theta,poi,consistency",
                      "--batchsize", "3", "--compute_dtype", "float32", "--device", "cpu",
                      "--court_img", COURT, "--court_poi", POI], num_data_workers=1)
        out[ext] = (dst / "game1_court.json").read_bytes()
    assert out["msgpack"] == out["pth"]
    assert len(json.loads(out["msgpack"])) == 5


def test_msgpack_state_dict_equals_pth(workspace):
    _, _, cp_dir = workspace
    got = engine.load_state_dict(str(cp_dir / "CP_epoch1.msgpack"))
    want = torch.load(cp_dir / "CP_epoch1.pth", weights_only=True)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_test_cli_scores_msgpack(tmp_path):
    """The port's test CLI finds ``CP_epoch{n}.msgpack`` and scores it as it
    scores the ``.pth`` of the same variables."""
    data = tmp_path / "synth"
    write_synthetic_dataset(str(data), 3, 2, COURT, POI, size=(W, H), seed=2)
    conf = dict(target_size=[W, H], unet_size=[W, H], warp_size=[W, H], court_size=[W, H],
                mask_classes=4, resnet_name="resnet18", resnet_input="img+mask")
    variables = near_identity_variables(1)
    results = {}
    for ext in ("msgpack", "pth"):
        cp_dir = tmp_path / ext
        cp_dir.mkdir()
        (cp_dir / "conf.yaml").write_text(json.dumps(conf))
        (save_checkpoint if ext == "msgpack" else save_torch_checkpoint)(
            str(cp_dir / f"CP_epoch3.{ext}"), variables)
        results[ext] = test_cli.main(
            ["--cp_dir", str(cp_dir), "--test_epochs", "3", "--img_dir", str(data / "frames"),
             "--mask_dir", str(data / "masks"), "--anno_dir", str(data / "anno"),
             "--batchsize", "2", "--court_img", COURT, "--court_poi", POI,
             "--compute_dtype", "float32", "--device", "cpu"], num_data_workers=1)["3"]
        assert (cp_dir / "test_scores.txt").read_text().count("Test scores:") == 1
    for k in ("val_reproj_px", "val_reproj_score", "val_seg_score", "val_rec_score"):
        assert np.isfinite(results["msgpack"][k]), k
        assert results["msgpack"][k] == results["pth"][k], k


def test_orbax_is_refused_with_the_export_script():
    with pytest.raises(NotImplementedError, match="export_torch_checkpoint"):
        engine.check_loadable("run/CP_epoch1.orbax")
