"""The predict CLI's full outputs (BASELINE config #2: segm and warp masks,
poi, theta, consistency) from both CLIs on the same frames and weights
(CPU, float32), and the pieces under them.

The workspace is ``tests/test_torch_predict_cli.py``'s: four 64x36 frames,
a resnet18 model from a numpy seed saved as ``.msgpack`` (the JAX CLI) and
``.pth`` (the port).  ``--out_size 100 56`` makes the final nearest resize
a non-integer ratio.  Bounds (``docs/PARITY.md``): theta max-abs 2e-4,
score 1e-3 plus the JSON's rounding, poi 5e-4; the warp masks' decoded
pixels differ on < 0.1 %; a segm_mask pixel may differ only where JAX's
two largest logits are within 1e-3.  PNG bytes are never compared: cv2's
encoder and the port's differ in filters and zlib level.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sports_field_homography_tpu.cli.predict import process as jax_process
from sports_field_homography_tpu.compat.torch_export import save_torch_checkpoint
from sports_field_homography_tpu.data.assets import open_court_poi
from sports_field_homography_tpu.data.assets import open_court_template as jax_template
from sports_field_homography_tpu.models import Reconstructor as JaxReconstructor
from sports_field_homography_tpu.models import ReconstructorConfig as JaxConfig
from sports_field_homography_tpu.utils import postprocess as jax_post
from sports_field_homography_tpu.utils.checkpoint import save_checkpoint
from sports_field_homography_tpu_torch.cli import predict as port_predict
from sports_field_homography_tpu_torch.cli.predict import (_cv2_nearest_index, _png_bytes,
                                                           _resize_masks)
from sports_field_homography_tpu_torch.cli.predict import process as port_process
from sports_field_homography_tpu_torch.data.assets import open_court_template
from sports_field_homography_tpu_torch.data.loader import Loader, device_prefetch
from sports_field_homography_tpu_torch.geometry.court import load_court_poi
from sports_field_homography_tpu_torch.data.png import encode_png, read_png, write_png
from sports_field_homography_tpu_torch.models import Reconstructor, ReconstructorConfig
from sports_field_homography_tpu_torch.models.layers import init_weights
from sports_field_homography_tpu_torch.ops.resize import resize_nearest
from sports_field_homography_tpu_torch.ops.warp import template_value_table, warp_nearest
from sports_field_homography_tpu_torch.utils import postprocess as port_post
from test_torch_predict_cli import COURT, POI, H, W, _seeded_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = (100, 56)
FULL = "segm_mask,warp_mask,theta,poi,consistency"


def near_identity_variables(seed):
    """``_seeded_variables`` with the STN's regression kernel scaled down,
    so that theta stays near the identity and every point of interest
    projects near the frame (a random theta sends some of them 100 frame
    widths out, where their projection amplifies rounding 1e4-fold)."""
    def scale(path, leaf):
        keys = [p.key for p in path]
        return leaf * np.float32(0.05) if "reg" in keys and keys[-1] == "kernel" else leaf

    return jax.tree_util.tree_map_with_path(scale, _seeded_variables(seed))


def make_workspace(root, n_frames, batch_size=3):
    """``n_frames`` seeded 64x36 PNG frames in ``root/game1``, a conf.yaml
    and the same weights as ``ckpt/model_v2/CP_epoch1.{msgpack,pth}``."""
    img_dir = root / "game1"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(n_frames):
        write_png(str(img_dir / f"{i:06d}.png"),
                  rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    cp_dir = root / "ckpt" / "model_v2"
    cp_dir.mkdir(parents=True)
    conf = {"target_size": [W, H], "unet_size": [W, H], "warp_size": [W, H],
            "court_size": [W, H], "mask_classes": 4, "resnet_name": "resnet18",
            "resnet_input": "img+mask", "use_unet": True, "use_resnet": True}
    with open(cp_dir / "conf.yaml", "w") as f:
        json.dump(conf, f)
    variables = near_identity_variables(0)
    save_checkpoint(str(cp_dir / "CP_epoch1.msgpack"), variables)
    save_torch_checkpoint(str(cp_dir / "CP_epoch1.pth"), variables)
    return root, img_dir, cp_dir


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return make_workspace(tmp_path_factory.mktemp("torch_predict_full"), 4)


def _argv(img_dir, ckpt, dst, mask_type="gray", fmt="png", req=FULL):
    return ["--img_dir", str(img_dir), "--load", str(ckpt), "--dst_dir", str(dst),
            "--req_outputs", req, "--out_size", str(OUT[0]), str(OUT[1]),
            "--batchsize", "3", "--compute_dtype", "float32", "--mask_type", mask_type,
            "--mask_save_format", fmt, "--court_img", COURT, "--court_poi", POI]


def _read_masks(dst, key, fmt):
    """{name: cv2-decoded mask} of one CLI's output.  The port pickles each
    PNG as an (n, 1) uint8 array (cv2 4's ``imencode``; cv2 5 gives (n,))."""
    sub = os.path.join(dst, "court", key)
    if fmt == "png":
        return {f[:-4]: cv2.imread(os.path.join(sub, f), cv2.IMREAD_UNCHANGED)
                for f in sorted(os.listdir(sub))}
    out = {}
    with open(os.path.join(sub, "data.pkl"), "rb") as f:
        while True:
            try:
                name, buf = pickle.load(f)
            except EOFError:
                return out
            assert isinstance(buf, np.ndarray) and buf.dtype == np.uint8
            assert os.path.basename(str(dst)) != "port" or buf.shape == (buf.size, 1)
            out[name] = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)


@pytest.fixture(scope="module")
def jax_margin(workspace):
    """{frame name: the JAX logits' top-2 margin at the logits grid}."""
    root, img_dir, cp_dir = workspace
    cfg = JaxConfig(target_size=(W, H), unet_size=(W, H), warp_size=(W, H),
                    resnet_name="resnet18", resnet_input="img+mask")
    model = JaxReconstructor(cfg, dtype=jnp.float32)
    names = sorted(os.listdir(img_dir))
    x = np.stack([cv2.imread(str(img_dir / n))[..., ::-1] for n in names]) / np.float32(255)
    out = model.apply(near_identity_variables(0), jnp.asarray(x, jnp.float32),
                      jnp.asarray(jax_template(COURT, 4, size=(W, H), batch_size=len(names))),
                      jnp.asarray(open_court_poi(POI, len(names))), train=False)
    top2 = np.sort(np.asarray(out["logits"]), axis=-1)[..., -2:]
    return {n[:-4]: top2[i, ..., 1] - top2[i, ..., 0] for i, n in enumerate(names)}


@pytest.mark.parametrize("fmt", ["png", "pickle"])
@pytest.mark.parametrize("mask_type", ["gray", "bin", "rgb"])
def test_port_cli_full_outputs_match_jax_cli(workspace, jax_margin, tmp_path,
                                              mask_type, fmt):
    root, img_dir, cp_dir = workspace
    jax_process(_argv(img_dir, cp_dir / "CP_epoch1.msgpack", tmp_path / "jax", mask_type, fmt))
    stats = port_process(_argv(img_dir, cp_dir / "CP_epoch1.pth", tmp_path / "port",
                               mask_type, fmt) + ["--device", "cpu"])
    assert stats["frames"] == 4 and stats["writer_seconds"] > 0
    want = json.load(open(tmp_path / "jax" / "game1_court.json"))
    got = json.load(open(tmp_path / "port" / "game1_court.json"))
    assert list(got) == list(want) and got["model"] == "model_v2" and len(got) == 5
    for name in (k for k in want if k != "model"):
        assert list(got[name]) == list(want[name]) == ["score", "theta", "poi"]
        np.testing.assert_allclose(got[name]["theta"], want[name]["theta"], rtol=0, atol=2e-4)
        assert abs(got[name]["score"] - want[name]["score"]) <= 1e-3 + 1e-6
        np.testing.assert_allclose(got[name]["poi"], want[name]["poi"], rtol=0, atol=5e-4)
        assert np.asarray(got[name]["poi"]).shape == (len(load_court_poi(POI)), 2)
    assert not os.path.exists(tmp_path / "port" / "game1_court_processing.json")

    shape = (OUT[1], OUT[0]) + ((3,) if mask_type == "rgb" else ())
    warp_diff = warp_total = 0
    for key in ("warp_mask", "segm_mask"):
        ours, theirs = (_read_masks(tmp_path / side, key, fmt) for side in ("port", "jax"))
        assert sorted(ours) == sorted(theirs) == ["000000", "000001", "000002", "000003"]
        for name in ours:
            a, b = ours[name], theirs[name]
            assert a.dtype == np.uint8 and a.shape == b.shape == shape
            diff = a != b if a.ndim == 2 else (a != b).any(-1)
            if key == "warp_mask":
                warp_diff += int(diff.sum())
                warp_total += diff.size
            else:
                rows = _cv2_nearest_index(H, OUT[1])
                cols = _cv2_nearest_index(W, OUT[0])
                margin = jax_margin[name][rows[:, None], cols[None, :]]
                assert (margin[diff] < 1e-3).all(), (name, int(diff.sum()))
        if fmt == "png" and key == "warp_mask":
            # the port's reader sees the file as RGB: cv2's BGR reversed
            a = read_png(str(tmp_path / "port" / "court" / key / "000000.png"))
            np.testing.assert_array_equal(a, ours["000000"][..., ::-1] if a.ndim == 3
                                          else ours["000000"])
    assert warp_diff < 1e-3 * warp_total, (warp_diff, warp_total)
    labels = np.unique(np.stack(list(_read_masks(tmp_path / "port", "warp_mask", fmt).values())))
    assert len(labels) >= 2        # the warp reaches the court


def test_full_outputs_run_without_cv2_and_pillow(workspace, tmp_path, monkeypatch):
    """The config #2 outputs need neither cv2 nor Pillow (the GPU machine
    has neither): blocked, the run writes what it writes with both."""
    root, img_dir, cp_dir = workspace
    argv = _argv(img_dir, cp_dir / "CP_epoch1.pth", tmp_path / "with", "rgb", "png")
    port_process(argv + ["--device", "cpu"])
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    argv = _argv(img_dir, cp_dir / "CP_epoch1.pth", tmp_path / "without", "rgb", "png")
    port_process(argv + ["--device", "cpu"])
    assert (json.load(open(tmp_path / "with" / "game1_court.json"))
            == json.load(open(tmp_path / "without" / "game1_court.json")))
    for key in ("segm_mask", "warp_mask"):
        for f in os.listdir(tmp_path / "with" / "court" / key):
            np.testing.assert_array_equal(read_png(str(tmp_path / "with" / "court" / key / f)),
                                          read_png(str(tmp_path / "without" / "court" / key / f)))


@pytest.mark.parametrize("extra", [["--req_outputs", "theta,debug"],
                                   ["--video_path", "clip.mp4", "--img_dir", None]])
def test_cv2_paths_refuse_before_the_model_is_built(workspace, tmp_path, monkeypatch,
                                                    extra):
    root, img_dir, cp_dir = workspace
    monkeypatch.setitem(sys.modules, "cv2", None)

    def no_model(*a, **k):
        raise AssertionError("the model was built")

    monkeypatch.setattr(port_predict, "build_model", no_model)
    argv = _argv(img_dir, cp_dir / "CP_epoch1.pth", tmp_path, "gray", "png") + ["--device", "cpu"]
    if "--img_dir" in extra:        # the video alone: drop --img_dir
        i = argv.index("--img_dir")
        argv = argv[:i] + argv[i + 2:]
        extra = extra[:2]
    with pytest.raises(RuntimeError, match="needs cv2"):
        port_process(argv + extra)


def _port_model(warp, target=(64, 36), seed=0):
    cfg = ReconstructorConfig(target_size=target, unet_size=target, warp_size=warp,
                              resnet_name="resnet18")
    model = Reconstructor(cfg)
    gen = torch.Generator().manual_seed(seed)
    init_weights(model, gen)
    with torch.no_grad():       # move theta off the identity
        model.resnet_reg.reg.weight.copy_(
            torch.randn(model.resnet_reg.reg.weight.shape, generator=gen) * 5e-3)
    labels_np = open_court_template(COURT, 4, size=warp)
    return (model.eval(), torch.from_numpy(labels_np),
            template_value_table(labels_np, 4))


@pytest.mark.parametrize("warp", [(128, 72), (100, 56), (640, 360)])
def test_shared_warp_labels_equal_sampled_grid(warp):
    """With warp_mask kept, K1 runs once on the full grid and the score's
    labels are its nearest downsample: equal bit for bit to K1 on the
    sampled grid, so the score and theta are unchanged."""
    model, labels, values = _port_model(warp)
    x = torch.from_numpy(np.random.default_rng(1).random((2, 36, 64, 3), np.float32))
    poi = torch.from_numpy(load_court_poi(POI).astype(np.float32))
    with torch.inference_mode():
        slim = model.predict(x, labels, values)
        full = model.predict(x, labels, values, warp_mask=True, court_poi=poi)
    assert set(slim) == {"logits", "theta", "consist_score"}
    assert set(full) == {"logits", "theta", "consist_score", "warp_mask", "poi"}
    assert full["warp_mask"].shape == (2, warp[1], warp[0])
    torch.testing.assert_close(full["consist_score"], slim["consist_score"], rtol=0, atol=0)
    torch.testing.assert_close(full["theta"], slim["theta"], rtol=0, atol=0)
    sampled = warp_nearest(labels, full["theta"], (warp[1], warp[0]), values,
                           sample_hw=(36, 64)) * 4
    down = resize_nearest(full["warp_mask"], (36, 64))
    assert torch.equal(down, sampled)
    assert len(torch.unique(full["warp_mask"])) >= 2


@pytest.mark.parametrize("src,dst", [((36, 64), (56, 100)), ((360, 640), (720, 1280)),
                                     ((720, 1280), (56, 100)), ((72, 128), (56, 100)),
                                     ((17, 33), (720, 1280)), ((56, 100), (17, 33))])
@pytest.mark.parametrize("channels", [0, 3])
def test_mask_resize_equals_cv2_inter_nearest(src, dst, channels):
    rng = np.random.default_rng(0)
    shape = (2,) + src + ((channels,) if channels else ())
    masks = rng.integers(0, 256, shape, dtype=np.uint8)
    got = _resize_masks(masks, (dst[1], dst[0]))
    want = np.stack([cv2.resize(m, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST)
                     for m in masks])
    np.testing.assert_array_equal(got, want)


def test_torch_nearest_resize_equals_jax_and_interpolate():
    from sports_field_homography_tpu.ops.resize import resize_nearest as jax_resize

    x = np.random.default_rng(2).random((2, 72, 128, 3), np.float32)
    for out in ((36, 64), (56, 100), (144, 256), (7, 9)):
        got = resize_nearest(torch.from_numpy(x), out).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_resize(jnp.asarray(x), out)))
        ref = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                                              size=out, mode="nearest")
        np.testing.assert_array_equal(got, ref.permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("shape", [(36, 64), (37, 65, 3), (720, 1280)])
def test_encode_png_round_trips_through_cv2(shape, tmp_path):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 4, shape, dtype=np.uint8) * 60
    buf = np.frombuffer(encode_png(img), np.uint8)
    got = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
    # encode_png stores the array as given (RGB); cv2 decodes to BGR
    np.testing.assert_array_equal(got, img[..., ::-1] if img.ndim == 3 else img)
    # the CLI's writers store a BGR mask as cv2.imencode does
    bgr = cv2.imdecode(np.frombuffer(_png_bytes(img), np.uint8), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(bgr, img)
    ok, ref = cv2.imencode(".png", img)
    np.testing.assert_array_equal(cv2.imdecode(ref, cv2.IMREAD_UNCHANGED), bgr)
    write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")), img)


def test_postprocess_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 9, 11, 4)).astype(np.float32)
    np.testing.assert_array_equal(port_post.preds_to_masks(logits, 4),
                                  jax_post.preds_to_masks(logits, 4))
    np.testing.assert_array_equal(port_post.preds_to_masks(logits[..., :1], 1, False),
                                  jax_post.preds_to_masks(logits[..., :1], 1, False))
    labels = rng.integers(0, 8, (2, 9, 11), dtype=np.uint8)
    for n in (4, 7, 8):
        np.testing.assert_array_equal(port_post.onehot_to_image(labels, n),
                                      jax_post.onehot_to_image(labels, n))
    frame = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    mask = port_post.onehot_to_image(labels[0] % 4, 4)[0]
    np.testing.assert_array_equal(port_post.overlay(frame, mask), jax_post.overlay(frame, mask))
    a, b = frame.copy(), frame.copy()
    port_post.draw_text(a, "0.123456", (2, 8))
    jax_post.draw_text(b, "0.123456", (2, 8))
    np.testing.assert_array_equal(a, b)


def test_device_prefetch_leaves_orig_img_on_the_host():
    batch = {"image": np.zeros((2, 4, 5, 3), np.uint8), "valid": np.ones(2, bool),
             "orig_img": np.zeros((2, 8, 10, 3), np.uint8), "name": ["a", "b"]}
    out = next(device_prefetch(iter([batch]), torch.device("cpu")))
    assert isinstance(out["image"], torch.Tensor) and isinstance(out["valid"], torch.Tensor)
    assert isinstance(out["orig_img"], np.ndarray) and out["name"] == ["a", "b"]


def test_loader_orig_img_is_bgr_at_file_size(workspace):
    from sports_field_homography_tpu.data.dataset import BasicDataset as JaxDataset
    from sports_field_homography_tpu_torch.data.dataset import BasicDataset

    root, img_dir, cp_dir = workspace
    ids = sorted(os.listdir(img_dir))
    ours = next(iter(Loader(BasicDataset(ids, str(img_dir), (32, 18), keep_orig_img=True), 4)))
    theirs = JaxDataset(ids, str(img_dir), target_size=(32, 18), keep_orig_img=True,
                        raw_uint8=True)
    for i in range(4):
        np.testing.assert_array_equal(ours["orig_img"][i], theirs[i]["orig_img"])
        np.testing.assert_array_equal(ours["image"][i], theirs[i]["image"])
    assert ours["orig_img"].shape == (4, H, W, 3)


def test_port_modules_import_no_cv2_pillow_or_jax():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.path.insert(0, {REPO!r})
        import sports_field_homography_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("cv2", "PIL", "jax"))
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
