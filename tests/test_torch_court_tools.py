"""The court-mapping tools: ``rescale_theta``, ``geometry/court.py``,
``utils/mapping_example.py`` and ``utils/viz_metrics.py``, the port against
the JAX package (CPU).

``rescale_theta`` (the tensor form and the numpy one of ``prep``) within
1e-6 relative; every numpy helper of ``geometry/court.py`` equal to JAX's;
``Warper`` (a nearest warp of any float image) against JAX's on < 0.1 % of
pixels, label boundaries only (``docs/PARITY.md``); ``CourtMapping`` on a
``{game}_court.json`` that the port's predict CLI wrote; the mapping
example's points within 1e-9 and its PNGs byte-equal; ``viz_metrics`` on
a ``test_scores.txt`` that the port's test CLI wrote, parsed exactly as
JAX parses it.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sports_field_homography_tpu.geometry import court as jax_court
from sports_field_homography_tpu.geometry.homography import rescale_theta as jax_rescale
from sports_field_homography_tpu.prep.preparation import rescale_theta as jax_rescale_np
from sports_field_homography_tpu.utils import mapping_example as jax_me
from sports_field_homography_tpu.utils import viz_metrics as jax_vm
from sports_field_homography_tpu_torch.cli import predict as port_predict
from sports_field_homography_tpu_torch.cli import test as port_test
from sports_field_homography_tpu_torch.data.synthetic import write_synthetic_dataset
from sports_field_homography_tpu_torch.geometry import court
from sports_field_homography_tpu_torch.geometry.homography import rescale_theta
from sports_field_homography_tpu_torch.prep.preparation import rescale_theta as rescale_np
from sports_field_homography_tpu_torch.utils import mapping_example as me
from sports_field_homography_tpu_torch.utils import viz_metrics as vm
from test_torch_predict_cli import COURT, POI, H, W
from test_torch_predict_full import make_workspace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PITCH_POI = os.path.join(REPO, "assets", "template_pitch_points.json")
THETA = np.array([[1.4, 0.1, 0.05], [0.02, 2.2, 0.6], [0.01, 0.9, 1.0]])


def test_rescale_theta_both_forms():
    rng = np.random.default_rng(0)
    thetas = (THETA + rng.standard_normal((4, 3, 3)) * 0.05).astype(np.float32)
    for src, dst in (((64, 36), (1280, 720)), ((1280, 720), (320, 180)), ((1, 1), (7, 3))):
        want = np.asarray(jax_rescale(jnp.asarray(thetas), src, dst))
        got = rescale_theta(torch.from_numpy(thetas), src, dst)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
        got64 = rescale_theta(torch.from_numpy(thetas).double(), src, dst)
        assert got64.dtype == torch.float64
        for i in range(len(thetas)):
            want_np = jax_rescale_np(src, dst, thetas[i].astype(np.float64))
            np.testing.assert_allclose(rescale_np(src, dst, thetas[i].astype(np.float64)),
                                       want_np, rtol=1e-6, atol=0)
            np.testing.assert_allclose(got64[i].numpy(), want_np, rtol=1e-6, atol=0)


def test_court_constants_and_poi():
    for name in ("COURT_IN_PIXELS", "FRAME_IN_PIXELS", "COURT_IN_METERS", "METERS2FEET",
                 "METERS2PIXELS", "PIXELS2METERS"):
        assert getattr(court.CourtSizes, name) == getattr(jax_court.CourtSizes, name), name
    for path in (POI, PITCH_POI):
        for normalize in (True, False):
            for homogeneous in (True, False):
                got = court.load_court_poi(path, normalize=normalize, homogeneous=homogeneous)
                want = jax_court.load_court_poi(path, normalize, homogeneous)
                np.testing.assert_array_equal(got, want)
    assert court.load_court_poi(PITCH_POI).shape == (33, 2)
    with pytest.raises(ValueError, match="Cannot read"):
        court.load_court_poi(COURT)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint16, np.int16])
@pytest.mark.parametrize("offsets", [((0, 0), (0, 0)), ((8, 8), (8, 8)), ((1, 3), (2, 0))])
def test_generate_uv_template(dtype, offsets):
    for size in ((64, 36), (37, 21)):
        got = court.generate_uv_template(size, dtype, *offsets)
        want = jax_court.generate_uv_template(size, dtype, *offsets)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == (size[1], size[0])
            np.testing.assert_array_equal(g, w)
    # the trailing trim is offset[1] + 1 pixels
    u, _ = court.generate_uv_template((10, 6), np.float32, (2, 3), (0, 0))
    assert (u[1, :2] == 0).all() and (u[1, 2:6] > 0).all() and (u[1, 6:] == 0).all()


def test_generate_uv_template_refuses_other_dtypes():
    with pytest.raises(NotImplementedError):
        court.generate_uv_template((8, 4), np.int32)


def test_point_mapping_helpers():
    rng = np.random.default_rng(2)
    theta = THETA + rng.standard_normal((3, 3)) * 0.05
    pts = rng.uniform(-1, 1, (11, 2))
    np.testing.assert_array_equal(court.transform_poi_np(theta, pts),
                                  jax_court.transform_poi_np(theta, pts))
    np.testing.assert_array_equal(court.transform_poi_np(theta, pts, normalize=True),
                                  jax_court.transform_poi_np(theta, pts, normalize=True))
    px = rng.uniform(0, 1280, (5, 2)).astype(np.float32)
    for size in (None, (1280, 720)):
        np.testing.assert_array_equal(court.map_frame_to_court(theta, px, size),
                                      jax_court.map_frame_to_court(theta, px, size))
        np.testing.assert_array_equal(court.map_court_to_frame(theta, px, size),
                                      jax_court.map_court_to_frame(theta, px, size))
    # a single point as a list, and the caller's array left as it was
    np.testing.assert_array_equal(court.map_frame_to_court(theta, [590, 418], (1280, 720)),
                                  jax_court.map_frame_to_court(theta, [590, 418], (1280, 720)))
    before = px.copy()
    court.map_court_to_frame(theta, px, (1280, 720))
    np.testing.assert_array_equal(px, before)
    fm = court.FrameMapping(theta, np.linalg.inv(theta), 0.25)
    assert fm.score == 0.25 and fm.theta_f2c is theta


@pytest.mark.parametrize("size,inter", [((1280, 720), None), ((3000, 1700), None),
                                        ((640, 360), 0)])
def test_load_court_mask(size, inter):
    path = os.path.join(REPO, "assets", "template_ncaa_v4_s.png")
    got = court.load_court_mask(path, size, inter)
    assert got.shape == (size[1], size[0], 3)
    np.testing.assert_array_equal(got, jax_court.load_court_mask(path, size, inter))


def test_warper_matches_jax():
    """A float image of three channels (court labels, a ramp, noise), warped
    by broadcast-camera homographies."""
    from sports_field_homography_tpu_torch.data.assets import open_court_template

    labels = open_court_template(COURT, 4, size=(320, 180)).astype(np.float32) / 4
    rng = np.random.default_rng(4)
    img = np.stack([labels, np.linspace(0, 1, 320, dtype=np.float32)[None].repeat(180, 0),
                    rng.random((180, 320), dtype=np.float32)], axis=-1)
    assert court.Warper((64, 36)).device.type == "cuda"         # the card by default
    assert court.Warper((64, 36), cuda=True).device.type == "cuda"
    port = court.Warper((200, 120), cuda=False)
    jax_w = jax_court.Warper((200, 120))
    differ = total = 0
    for i in range(4):
        theta = THETA + rng.standard_normal((3, 3)) * np.array(
            [[.15, .05, .1], [.05, .3, .15], [.005, .1, .05]])
        got = port.warp(theta, img)
        want = jax_w.warp(theta, img)
        assert got.shape == want.shape == (120, 200, 3) and got.dtype == np.float32
        bad = np.any(got != want, axis=-1)
        differ += int(bad.sum())
        total += bad.size
        # a differing pixel sits on a label boundary of JAX's warp
        lab = want[..., 0]
        edge = np.zeros_like(bad)
        edge[1:, :] |= lab[1:, :] != lab[:-1, :]
        edge[:-1, :] |= lab[1:, :] != lab[:-1, :]
        edge[:, 1:] |= lab[:, 1:] != lab[:, :-1]
        edge[:, :-1] |= lab[:, 1:] != lab[:, :-1]
        assert not (bad & ~edge).any()
        assert (want[..., 0] > 0).mean() > 0.05              # the court is in view
    assert differ / total < 1e-3, differ


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The port's predict CLI on four frames and its test CLI on a synthetic
    set, both on the CPU from one checkpoint."""
    root, img_dir, cp_dir = make_workspace(tmp_path_factory.mktemp("court_tools"), 4)
    port_predict.process(["--img_dir", str(img_dir), "--load", str(cp_dir / "CP_epoch1.pth"),
                          "--dst_dir", str(root / "preds"), "--req_outputs",
                          "theta,consistency", "--batchsize", "2", "--compute_dtype",
                          "float32", "--court_img", COURT, "--court_poi", POI,
                          "--device", "cpu"])
    data = root / "synth"
    write_synthetic_dataset(str(data), 3, 2, COURT, POI, size=(W, H), seed=0)
    for _ in range(2):          # two test sweeps: two records in the log
        port_test.main(["--cp_dir", str(cp_dir), "--test_epochs", "1", "--img_dir",
                        str(data / "frames"), "--mask_dir", str(data / "masks"),
                        "--anno_dir", str(data / "anno"), "--batchsize", "2",
                        "--court_img", COURT, "--court_poi", POI, "--device", "cpu",
                        "--compute_dtype", "float32"], num_data_workers=1)
    return root, cp_dir


def test_court_mapping_on_a_port_prediction(port_runs, capsys):
    root, _ = port_runs
    path = str(root / "preds" / "game1_court.json")
    raw = json.load(open(path))
    assert raw["model"] == "model_v2" and len(raw) == 5
    got = court.CourtMapping(path)
    assert "predicted by the model_v2 model" in capsys.readouterr().out
    want = jax_court.CourtMapping(path)
    assert sorted(got.frames) == sorted(want.frames) == [f"{i:06d}" for i in range(4)]
    for name, fm in got.frames.items():
        np.testing.assert_array_equal(fm.theta_f2c, want.frames[name].theta_f2c)
        np.testing.assert_array_equal(fm.theta_c2f, want.frames[name].theta_c2f)
        assert fm.score == want.frames[name].score
        np.testing.assert_array_equal(fm.theta_f2c, np.asarray(raw[name]["theta"])[0])


def test_mapping_example_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)
    got = me.map_frame_points_to_court(out_path=str(tmp_path / "a.png"))
    want = jax_me.map_frame_points_to_court(out_path=str(tmp_path / "ja.png"))
    assert got.shape == (1, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    got = me.map_court_poi_to_frame(out_path=str(tmp_path / "b.png"))
    want = jax_me.map_court_poi_to_frame(out_path=str(tmp_path / "jb.png"))
    assert got.shape == (52, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    for a, b in (("a.png", "ja.png"), ("b.png", "jb.png")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()


def test_viz_metrics_on_a_port_test_log(port_runs, tmp_path):
    _, cp_dir = port_runs
    log = str(cp_dir / "test_scores.txt")
    got = vm.read_log(log)
    assert len(got) == 2 and got == jax_vm.read_log(log)
    assert all(np.isfinite(list(c.values())[1:]).all() for c in got)
    assert got[0]["epoch"] == "CP_epoch1.msgpack"
    assert vm.read_log(log, max_reproj_px=-1.0) == jax_vm.read_log(log, max_reproj_px=-1.0) == []
    assert vm.read_log(log, target_dataset="synth") == jax_vm.read_log(log, "synth")
    assert vm.parse_model_dir(str(cp_dir)) == jax_vm.parse_model_dir(str(cp_dir))
    keys = ["reproj_px", "reproj_rmse", "segm_ce", "rec_mse", "imgs_per_sec"]
    scores = [dict(got[0], name="a"), dict(got[1], name="b")]
    assert vm.make_score_log(scores, keys) == jax_vm.make_score_log(scores, keys)
    # the charts and the ranked log over a directory of model dirs
    out_port, out_jax = tmp_path / "port", tmp_path / "jax"
    src = str(cp_dir.parent)
    assert vm.vizualize_metrics(src, str(out_port)) == jax_vm.vizualize_metrics(src, str(out_jax))
    assert sorted(os.listdir(out_port)) == sorted(os.listdir(out_jax))
    assert (out_port / "scores.txt").read_text() == (out_jax / "scores.txt").read_text()
