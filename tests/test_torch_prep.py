"""Dataset preparation (``prep/``): the port against the JAX package on the
same seeded inputs (CPU; numpy, cv2 and Pillow on the host).

Homography fits (cv2 and the normalized DLT) within 1e-9; reprojection
RMSE, visibility masks and annotation requests equal; ``generate_onehot``
on seeded class-colour masks bit-equal; ``build_dataset`` (with ``--uv``)
on a seeded ``manual_anno.json`` set writing byte-equal files; both Narya
converters on seeded VOC XML, ``_homo.npy`` and frames writing equal
annotations and byte-equal frames.  Nothing is downloaded.
"""
import json
import os
import shutil

import cv2
import numpy as np
import pytest

from sports_field_homography_tpu import prep as jax_prep
from sports_field_homography_tpu.prep import build_dataset as jax_build
from sports_field_homography_tpu.prep import narya as jax_narya
from sports_field_homography_tpu.prep import preparation as jax_pp
from sports_field_homography_tpu_torch import prep
from sports_field_homography_tpu_torch.geometry.court import load_court_poi
from sports_field_homography_tpu_torch.prep import build_dataset, narya
from sports_field_homography_tpu_torch.prep import preparation as pp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NCAA_POI = os.path.join(REPO, "assets", "template_ncaa_v4_points.json")
PITCH_POI = os.path.join(REPO, "assets", "template_pitch_points.json")
NCAA_MASK = os.path.join(REPO, "assets", "mask_ncaa_v4_nc4_m_onehot.png")
BASE_H = np.array([[0.8, 0.05, 0.1], [0.02, 0.7, 0.15], [0.01, 0.02, 1.0]])


def _manual_poi(field, rng, missing=4, noise=2e-3):
    """Field points through a seeded homography, a few missing (-1, -1)
    and annotation noise on the rest."""
    h = BASE_H + rng.standard_normal((3, 3)) * np.array(
        [[.05, .02, .03], [.02, .05, .03], [.005, .005, 0]])
    ph = np.concatenate([field, np.ones((len(field), 1))], 1) @ h.T
    pts = ph[:, :2] / ph[:, 2:3] + rng.standard_normal((len(field), 2)) * noise
    pts[rng.choice(len(field), missing, replace=False)] = -1.0
    return pts


def test_exports_and_constants():
    assert sorted(n for n in dir(prep) if not n.startswith("_") and n.isupper()) == \
        sorted(n for n in dir(jax_prep) if not n.startswith("_") and n.isupper())
    for name in jax_prep.__dict__:
        if not name.startswith("_") and not name[0].islower():
            assert getattr(prep, name) == getattr(jax_prep, name), name
    for name in ("generate_requests", "calculate_homography", "find_homography_dlt",
                 "find_nonzero_points", "calculate_reprojection_rmse", "rescale_theta",
                 "generate_onehot", "convert_rgb_to_onehot", "convert_narya_keypoints",
                 "convert_narya_homography"):
        assert callable(getattr(prep, name)), name
    assert pp.MASK_CLASS_MAPPINGS == jax_pp.MASK_CLASS_MAPPINGS
    assert pp.FOOTBALL_PITCH_IGNORE_POINTS == jax_pp.FOOTBALL_PITCH_IGNORE_POINTS
    assert narya.NARYA_TO_OUR_POI == jax_narya.NARYA_TO_OUR_POI
    with pytest.raises(NotImplementedError):
        pp.generate_onehot("/nonexistent", num_classes=5)


@pytest.mark.parametrize("poi_path", [NCAA_POI, PITCH_POI])
@pytest.mark.parametrize("use_cv2", [True, False])
def test_homography_fits_match_jax(poi_path, use_cv2):
    field = load_court_poi(poi_path, normalize=False)
    rng = np.random.default_rng(11)
    for _ in range(3):
        manual = _manual_poi(field, rng)
        got = pp.calculate_homography(field, manual, use_cv2=use_cv2)
        want = jax_pp.calculate_homography(field, manual, use_cv2=use_cv2)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    keep = manual[:, 0] != -1
    np.testing.assert_allclose(pp.find_homography_dlt(field[keep], manual[keep]),
                               jax_pp.find_homography_dlt(field[keep], manual[keep]),
                               rtol=0, atol=1e-9)
    few = np.full_like(manual, -1.0)
    few[:3] = manual[:3]
    assert pp.calculate_homography(field, few, use_cv2) is None
    assert jax_pp.calculate_homography(field, few, use_cv2) is None


def test_rmse_masks_and_requests(tmp_path):
    field = load_court_poi(PITCH_POI, normalize=False)
    rng = np.random.default_rng(12)
    manual = _manual_poi(field, rng, missing=6)
    for ignore in (None, pp.FOOTBALL_PITCH_IGNORE_POINTS):
        got = pp.find_nonzero_points(manual, ignore)
        np.testing.assert_array_equal(got, jax_pp.find_nonzero_points(manual, ignore))
        for norm in (None, (1280, 720)):
            assert pp.calculate_reprojection_rmse(field, manual, got, norm) == \
                jax_pp.calculate_reprojection_rmse(field, manual, got, norm)
    assert pp.calculate_reprojection_rmse(field, manual) == \
        jax_pp.calculate_reprojection_rmse(field, manual)
    # two games of manual annotations, one frame with an rmse
    for g, game in enumerate(("game_a", "game_b")):
        (tmp_path / game).mkdir()
        anno = {f"{i:06d}": {"poi": _manual_poi(field, rng).tolist()} for i in range(2 + g)}
        anno["000000"]["rmse"] = 1.5
        json.dump(anno, open(tmp_path / game / "manual_anno.json", "w"))
    (tmp_path / "not_a_game.txt").write_text("x")
    got, want = pp.generate_requests(str(tmp_path)), jax_pp.generate_requests(str(tmp_path))
    assert sorted(got) == sorted(want) == ["game_a", "game_b"]
    for game in want:
        assert list(got[game]) == list(want[game])
        for fid, req in want[game].items():
            assert set(got[game][fid]) == set(req)
            np.testing.assert_array_equal(got[game][fid]["manual_poi"], req["manual_poi"])
            for k in ("poi", "theta", "rmse"):
                assert got[game][fid][k] == req[k], (game, fid, k)


@pytest.mark.parametrize("num_classes", [4, 7, 8])
def test_generate_onehot_bit_equal(tmp_path, num_classes):
    rng = np.random.default_rng(num_classes)
    # the mapping's colours are matched against the pixels as cv2 reads them
    colors = [(0, 0, 0), (10, 20, 30)] + list(jax_pp.MASK_CLASS_MAPPINGS[num_classes].values())
    for side in ("jax", "port"):
        (tmp_path / side / "g").mkdir(parents=True)
    for i in range(3):
        idx = rng.integers(0, len(colors), (18, 32))
        bgr = np.asarray(colors, np.uint8)[idx]
        for side in ("jax", "port"):
            cv2.imwrite(str(tmp_path / side / "g" / f"{i:06d}.png"), bgr)
    assert jax_pp.generate_onehot(str(tmp_path / "jax"), num_classes, num_workers=1) == 3
    assert pp.generate_onehot(str(tmp_path / "port"), num_classes, num_workers=1) == 3
    for i in range(3):
        name = f"g/{i:06d}.png"
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes()
        labels = cv2.imread(str(tmp_path / "port" / name), cv2.IMREAD_UNCHANGED)
        assert labels.ndim == 2 and labels.max() == num_classes - 1


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_build_dataset_with_uv_byte_equal(tmp_path):
    field = load_court_poi(NCAA_POI, normalize=False)
    rng = np.random.default_rng(13)
    src = tmp_path / "anno_src"
    for game, n in (("game1", 3), ("game2", 2)):
        (src / game).mkdir(parents=True)
        anno = {f"{i + 1:06d}": {"poi": _manual_poi(field, rng).tolist()} for i in range(n)}
        anno["000002"]["poi"] = np.full_like(field, -1.0).tolist()     # < 4 points: skipped
        json.dump(anno, open(src / game / "manual_anno.json", "w"))
    argv = ["--anno_dir", str(src), "--field_poi", NCAA_POI, "--field_mask", NCAA_MASK,
            "--mask_size", "128", "72", "--ignore_pts", "1,2", "--uv", "--uv_offset", "4", "2"]
    want = jax_build.main(argv + ["--dst_dir", str(tmp_path / "jax")])
    got = build_dataset.main(argv + ["--dst_dir", str(tmp_path / "port")])
    assert got == want == {"game1": 2, "game2": 1}
    files_j, files_p = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(files_p) == sorted(files_j)
    assert sum(f.endswith(".tif") for f in files_p) == 3
    assert sum(f.endswith(".png") for f in files_p) == 3
    for name, data in files_j.items():
        assert files_p[name] == data, name
    mask = cv2.imread(str(tmp_path / "port" / "masks" / "game1" / "000001.png"), 0)
    assert set(np.unique(mask)) == {0, 1, 2, 3}


def _frame(path, w, h, seed):
    rng = np.random.RandomState(seed)
    cv2.imwrite(str(path), rng.randint(0, 255, (h, w, 3), np.uint8))


def test_narya_keypoints_converter(tmp_path):
    rng = np.random.default_rng(14)
    (tmp_path / "img").mkdir()
    (tmp_path / "anno").mkdir()
    for i, (w, h) in enumerate(((100, 50), (320, 180), (64, 36))):
        _frame(tmp_path / "img" / f"wc_{i}.jpg", w, h, i)
        objs = "".join(
            f"<object><name>{k}</name><keypoints><x1>{rng.uniform(0, w):.3f}</x1>"
            f"<y1>{rng.uniform(0, h):.3f}</y1></keypoints></object>"
            for k in rng.choice(29, 6, replace=False))
        (tmp_path / "anno" / f"wc_{i}.xml").write_text(
            f"<annotation><size><width>{w}</width><height>{h}</height></size>{objs}"
            "</annotation>")
    (tmp_path / "anno" / "wc_9.xml").write_text("<annotation/>")      # no frame: skipped
    outs = {}
    for side, mod in (("jax", jax_narya), ("port", narya)):
        argv = ["keypoints", "--src_img_dir", str(tmp_path / "img"), "--src_anno_dir",
                str(tmp_path / "anno"), "--dst_dir", str(tmp_path / side),
                "--frame_size", "64", "36"]
        mod.main(argv)
        outs[side] = _tree(tmp_path / side)
    assert sorted(outs["port"]) == sorted(outs["jax"])
    assert len(outs["port"]) == 4                       # 3 frames + manual_anno.json
    for name, data in outs["jax"].items():
        assert outs["port"][name] == data, name
    labels = json.load(open(tmp_path / "port" / "manual_anno.json"))
    poi = np.asarray(labels["000001"]["poi"])
    assert poi.shape == (33, 2) and (poi == -1).all(axis=1).sum() == 33 - 6


def test_narya_homography_converter(tmp_path):
    rng = np.random.default_rng(15)
    (tmp_path / "img").mkdir()
    (tmp_path / "homo").mkdir()
    for i, (w, h) in enumerate(((1024, 1024), (180, 360), (64, 36))):
        _frame(tmp_path / "img" / f"{100 + i}.jpg", w, h, i)
        hm = BASE_H + rng.standard_normal((3, 3)) * 0.02
        np.save(tmp_path / "homo" / f"{100 + i}_homo.npy", hm[None] if i == 0 else hm)
    np.save(tmp_path / "homo" / "200_homo.npy", BASE_H)                 # no frame: skipped
    counts = {}
    for side, mod in (("jax", jax_narya), ("port", narya)):
        counts[side] = mod.convert_narya_homography(
            str(tmp_path / "img"), str(tmp_path / "homo"), str(tmp_path / side / "frames"),
            str(tmp_path / side), PITCH_POI, frame_size=(64, 36))
    assert counts["port"] == counts["jax"] == 3
    files_j, files_p = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(files_p) == sorted(files_j)
    for name, data in files_j.items():
        assert files_p[name] == data, name
    labels = json.load(open(tmp_path / "port" / "manual_anno.json"))
    assert [labels[k]["rmse"] for k in sorted(labels)] == [7.0, 10.0, 5.0]


def test_convert_rgb_to_onehot_walks_subdirs(tmp_path):
    """The in-place conversion reaches masks in nested directories, with
    an explicit mapping."""
    mapping = {1: (0, 255, 0), 2: (255, 0, 0)}
    for side in ("jax", "port"):
        (tmp_path / side / "a" / "b").mkdir(parents=True)
        img = np.zeros((6, 9, 3), np.uint8)
        img[:2] = (0, 255, 0)
        img[2:4] = (255, 0, 0)
        cv2.imwrite(str(tmp_path / side / "a" / "b" / "m.png"), img)
        shutil.copy(tmp_path / side / "a" / "b" / "m.png", tmp_path / side / "top.png")
    assert jax_pp.convert_rgb_to_onehot(str(tmp_path / "jax"), mapping, 1) == 2
    assert pp.convert_rgb_to_onehot(str(tmp_path / "port"), mapping, 1) == 2
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
