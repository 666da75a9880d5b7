"""The video source and the debug renders of the port's predict CLI, held
to the JAX CLI on the CPU (float32).  Both need cv2; these tests skip only
where it is missing.

An mp4 of seeded 128x72 frames is written with ``cv2.VideoWriter``; both
CLIs read it with ``--video_path`` (frames shrunk to 64x36 with
``INTER_AREA``, named ``<video>/<i:06d>``, the game named after the
video's directory) and render ``court/debug/<name>.jpeg`` over the frame
at its own size.  Bounds as in ``tests/test_torch_predict_full.py``; a
debug render may differ from JAX's only where the inputs differ by
rounding (a warp label at a boundary, the score's sixth decimal in the
text), on < 1 % of its pixels.
"""
import json
import os

import numpy as np
import pytest

from sports_field_homography_tpu.cli.predict import process as jax_process
from sports_field_homography_tpu_torch.cli.predict import process as port_process
from sports_field_homography_tpu_torch.data.loader import Loader
from test_torch_predict_cli import COURT, POI
from test_torch_predict_full import make_workspace

try:
    import cv2
except ImportError:
    cv2 = None

N_FRAMES = 7
VW, VH = 128, 72


@pytest.fixture(autouse=True)
def _needs_cv2():
    if cv2 is None:
        pytest.skip("needs cv2 (video decode, JPEG, text)")


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    if cv2 is None:
        pytest.skip("needs cv2 (video decode, JPEG, text)")
    root, img_dir, cp_dir = make_workspace(tmp_path_factory.mktemp("video"), 3)
    vdir = root / "vgame"
    vdir.mkdir()
    video = str(vdir / "clip.mp4")
    wr = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 10, (VW, VH))
    rng = np.random.default_rng(1)
    base = rng.integers(0, 256, (VH // 8, VW // 8, 3), dtype=np.uint8)
    for i in range(N_FRAMES):       # smooth frames that move: a codec keeps them
        frame = cv2.resize(np.roll(base, i, axis=1), (VW, VH), interpolation=cv2.INTER_CUBIC)
        wr.write(frame)
    wr.release()
    return dict(root=root, img_dir=img_dir, cp_dir=cp_dir, video=video)


def _argv(source, ckpt, dst, req="segm_mask,warp_mask,theta,poi,consistency,debug"):
    return source + ["--load", str(ckpt), "--dst_dir", str(dst), "--req_outputs", req,
                     "--out_size", "100", "56", "--batchsize", "3",
                     "--compute_dtype", "float32", "--mask_save_format", "png",
                     "--court_img", COURT, "--court_poi", POI]


@pytest.fixture(scope="module")
def video_runs(workspace, tmp_path_factory):
    out = {}
    for side, ext, run, extra in (("jax", "msgpack", jax_process, []),
                                  ("port", "pth", port_process, ["--device", "cpu"])):
        dst = tmp_path_factory.mktemp(f"video_{side}")
        run(_argv(["--video_path", workspace["video"]],
                  workspace["cp_dir"] / f"CP_epoch1.{ext}", dst) + extra)
        out[side] = dst
    return out


def _debug_images(dst):
    sub = os.path.join(dst, "court", "debug")
    return {f: cv2.imread(os.path.join(sub, f)) for f in sorted(os.listdir(sub))}


def _assert_debug_close(ours, theirs, shape):
    assert sorted(ours) == sorted(theirs) and ours
    for name in ours:
        a, b = ours[name].astype(np.int16), theirs[name].astype(np.int16)
        assert a.shape == b.shape == shape
        far = (np.abs(a - b) > 48).any(-1)
        assert far.mean() < 0.01, (name, far.mean())
        assert np.abs(a - b).mean() < 2.0, (name, np.abs(a - b).mean())


def test_video_frames_equal_jax(workspace):
    """Decoded and shrunk frames equal the JAX dataset's bit for bit, in
    order, on one decode thread and on three; the tail padding replays
    the last frame."""
    from sports_field_homography_tpu.data.dataset import VideoDataset as JaxVideo
    from sports_field_homography_tpu_torch.data.dataset import VideoDataset

    theirs = JaxVideo(workspace["video"], target_size=(64, 36), keep_orig_img=True,
                      raw_uint8=True)
    want = [theirs[i] for i in range(N_FRAMES)]
    theirs.close()
    for workers in (1, 3):
        ds = VideoDataset(workspace["video"], target_size=(64, 36), keep_orig_img=True,
                          decode_workers=workers, decode_ahead=4)
        assert len(ds) == N_FRAMES and ds.name == "clip"
        batches = list(Loader(ds, 3, num_workers=1))
        ds.close()
        assert [b["num_valid"] for b in batches] == [3, 3, 1]
        names = sum((b["name"][:b["num_valid"]] for b in batches), [])
        assert names == [f"clip/{i:06d}" for i in range(N_FRAMES)]
        images = np.concatenate([b["image"] for b in batches])
        origs = np.concatenate([b["orig_img"] for b in batches])
        for i in range(N_FRAMES):
            assert images[i].dtype == np.uint8 and images[i].shape == (36, 64, 3)
            np.testing.assert_array_equal(images[i], want[i]["image"])
            np.testing.assert_array_equal(origs[i], want[i]["orig_img"])
        if workers > 1:     # the padded tail replays the last frame
            np.testing.assert_array_equal(images[-1], want[-1]["image"])


def test_video_set_range_reads_from_lo(workspace):
    from sports_field_homography_tpu_torch.data.dataset import VideoDataset

    full = VideoDataset(workspace["video"], target_size=(64, 36))
    want = [full[i]["image"] for i in range(N_FRAMES)]
    full.close()
    for workers in (1, 2):
        ds = VideoDataset(workspace["video"], target_size=(64, 36), decode_workers=workers)
        ds.set_range(4, N_FRAMES)
        for i in range(4, N_FRAMES):
            sample = ds[i]
            assert sample["name"] == f"clip/{i:06d}"
            np.testing.assert_array_equal(sample["image"], want[i])
        if workers > 1:
            with pytest.raises(RuntimeError, match="set_range"):
                ds.set_range(0, 2)
        ds.close()


def test_video_cli_matches_jax(video_runs):
    want = json.load(open(video_runs["jax"] / "vgame_court.json"))
    got = json.load(open(video_runs["port"] / "vgame_court.json"))
    assert list(got) == list(want) == [f"{i:06d}" for i in range(N_FRAMES)] + ["model"]
    assert got["model"] == want["model"] == "model_v2"
    for name in list(want)[:-1]:
        assert list(got[name]) == ["score", "theta", "poi"]
        np.testing.assert_allclose(got[name]["theta"], want[name]["theta"], rtol=0, atol=2e-4)
        assert abs(got[name]["score"] - want[name]["score"]) <= 1e-3 + 1e-6
        np.testing.assert_allclose(got[name]["poi"], want[name]["poi"], rtol=0, atol=5e-4)
    for key in ("segm_mask", "warp_mask"):
        sub = [os.path.join(video_runs[s], "court", key) for s in ("port", "jax")]
        assert sorted(os.listdir(sub[0])) == sorted(os.listdir(sub[1])) == \
            [f"{i:06d}.png" for i in range(N_FRAMES)]
        if key == "warp_mask":
            diff = sum(int((cv2.imread(os.path.join(sub[0], f), cv2.IMREAD_UNCHANGED)
                            != cv2.imread(os.path.join(sub[1], f), cv2.IMREAD_UNCHANGED)).sum())
                       for f in os.listdir(sub[0]))
            assert diff < 1e-3 * N_FRAMES * 100 * 56


def test_video_debug_renders_match_jax(video_runs):
    _assert_debug_close(_debug_images(video_runs["port"]), _debug_images(video_runs["jax"]),
                        (VH, VW, 3))


@pytest.mark.parametrize("mask_type", ["gray", "rgb"])
def test_image_dir_debug_renders_match_jax(workspace, tmp_path, mask_type):
    """Debug renders from an image directory, over the BGR frame at its
    file's own size; debug alone forces the warp mask."""
    source = ["--img_dir", str(workspace["img_dir"])]
    req = "theta,poi,consistency,debug"
    extra = ["--mask_type", mask_type]
    jax_process(_argv(source, workspace["cp_dir"] / "CP_epoch1.msgpack", tmp_path / "jax",
                      req) + extra)
    port_process(_argv(source, workspace["cp_dir"] / "CP_epoch1.pth", tmp_path / "port",
                       req) + extra + ["--device", "cpu"])
    ours, theirs = _debug_images(tmp_path / "port"), _debug_images(tmp_path / "jax")
    assert sorted(ours) == ["000000.jpeg", "000001.jpeg", "000002.jpeg"]
    _assert_debug_close(ours, theirs, (36, 64, 3))
    assert sorted(os.listdir(tmp_path / "port" / "court")) == ["debug", "warp_mask"]
