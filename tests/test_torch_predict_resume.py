"""The port's predict CLI with ``--resume`` (CPU, float32): the cases of
``tests/test_predict_resume.py`` (the JAX CLI's), run against the port.

An interrupted run's part JSONL is the resume ledger: recorded frames are
skipped (sentinel records survive untouched), a torn tail record is
dropped and its frame predicted again, a torn pickle record is cut before
appending, a resumed run with nothing left still merges, and a resumed
run reproduces the merged JSON of a run that was never interrupted.
"""
import json
import os
import pickle

import numpy as np
import pytest

from sports_field_homography_tpu_torch.cli.predict import (_read_resume_names,
                                                           _truncate_torn_pickle, process)
from test_torch_predict_cli import COURT, POI, H, W
from test_torch_predict_full import make_workspace

N_FRAMES = 6
SENTINEL = [[999.0, 0.0, 0.0], [0.0, 999.0, 0.0], [0.0, 0.0, 999.0]]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root, img_dir, cp_dir = make_workspace(tmp_path_factory.mktemp("resume"), N_FRAMES)
    return dict(root=root, img_dir=img_dir, cp=cp_dir / "CP_epoch1.pth")


def run(workspace, dst, extra=None, source=None):
    argv = (source or ["--img_dir", str(workspace["img_dir"])]) + [
        "--load", str(workspace["cp"]), "--dst_dir", str(dst),
        "--req_outputs", "theta,consistency", "--out_size", str(W), str(H),
        "--batchsize", "2", "--compute_dtype", "float32", "--device", "cpu",
        "--court_img", COURT, "--court_poi", POI] + (extra or [])
    return process(argv)


def _seed_part(dst, names, torn_tail=None, game="game1"):
    """A part JSONL as an interrupted run leaves it, with sentinel records."""
    os.makedirs(dst, exist_ok=True)
    part = os.path.join(str(dst), f"{game}_court_processing.json")
    with open(part, "w") as f:
        for n in names:
            f.write(json.dumps({n: {"theta": [SENTINEL], "score": -1.0}}) + "\n")
        if torn_tail is not None:
            f.write(torn_tail)       # the crash: no trailing newline
    return part


def _frames(path):
    out = json.load(open(path))
    assert out.pop("model") == "model_v2"
    return out


@pytest.fixture(scope="module")
def full_run(workspace, tmp_path_factory):
    dst = tmp_path_factory.mktemp("full_run")
    run(workspace, dst)
    return _frames(dst / "game1_court.json")


def _is_predicted(rec, full_run, name):
    return rec == full_run[name] and rec["theta"] != [SENTINEL]


def test_resume_skips_recorded_frames(workspace, full_run, tmp_path):
    done = [f"{i:06d}" for i in range(3)]
    _seed_part(tmp_path, done)
    stats = run(workspace, tmp_path, extra=["--resume"])
    assert stats["frames"] == N_FRAMES - 3
    frames = _frames(tmp_path / "game1_court.json")
    assert len(frames) == N_FRAMES
    for n in done:      # the sentinel untouched: the frame was not predicted
        assert frames[n] == {"theta": [SENTINEL], "score": -1.0}
    for i in range(3, N_FRAMES):
        assert _is_predicted(frames[f"{i:06d}"], full_run, f"{i:06d}")
    assert not os.path.exists(tmp_path / "game1_court_processing.json")


def test_resume_repairs_torn_tail(workspace, full_run, tmp_path):
    """A record torn in the middle of its line is dropped and its frame
    predicted again."""
    _seed_part(tmp_path, ["000000", "000001"], torn_tail='{"000002": {"theta": [[')
    assert run(workspace, tmp_path, extra=["--resume"])["frames"] == N_FRAMES - 2
    frames = _frames(tmp_path / "game1_court.json")
    assert len(frames) == N_FRAMES
    assert frames["000000"]["theta"] == frames["000001"]["theta"] == [SENTINEL]
    assert _is_predicted(frames["000002"], full_run, "000002")


def test_resume_with_nothing_left_still_merges(workspace, tmp_path):
    names = [f"{i:06d}" for i in range(N_FRAMES)]
    _seed_part(tmp_path, names)
    assert run(workspace, tmp_path, extra=["--resume"])["frames"] == 0
    frames = _frames(tmp_path / "game1_court.json")
    assert sorted(frames) == names
    assert all(frames[n]["theta"] == [SENTINEL] for n in names)
    assert not os.path.exists(tmp_path / "game1_court_processing.json")


def test_fresh_run_ignores_resume_flag_without_part(workspace, full_run, tmp_path):
    """--resume with no part file is a fresh run."""
    assert run(workspace, tmp_path, extra=["--resume"])["frames"] == N_FRAMES
    assert _frames(tmp_path / "game1_court.json") == full_run


def test_read_resume_names_repair_unit(tmp_path):
    part = tmp_path / "part.json"
    # one clean record, one complete record missing its newline (a crash
    # between json.dump and the "\n")
    with open(part, "w") as f:
        f.write('{"a": {"score": 1.0}}\n')
        f.write('{"b": {"score": 2.0}}')
    assert _read_resume_names(str(part)) == {"a", "b"}
    # the repair added the newline: appends stay one record a line
    assert open(part).read().endswith('{"b": {"score": 2.0}}\n')
    with open(part, "a") as f:
        f.write('{"c": {"score"')      # torn in the middle of the record
    assert _read_resume_names(str(part)) == {"a", "b"}
    assert open(part).read().count("\n") == 2
    assert _read_resume_names(str(tmp_path / "missing.json")) == set()


def test_truncate_torn_pickle_unit(tmp_path):
    path = str(tmp_path / "data.pkl")
    with open(path, "wb") as f:
        pickle.dump(["a", b"png-bytes-a"], f)
        pickle.dump(["b", b"png-bytes-b"], f)
        f.write(b"\x80\x04\x95torn")          # the crash, mid-dump
    _truncate_torn_pickle(path)
    names = []
    with open(path, "rb") as f:
        try:
            while True:
                names.append(pickle.load(f)[0])
        except EOFError:
            pass
    assert names == ["a", "b"]
    size = os.path.getsize(path)
    _truncate_torn_pickle(path)       # a clean stream is left as it is
    assert os.path.getsize(path) == size


def test_resume_repairs_torn_pickle_stream(workspace, tmp_path):
    """The torn tail record is cut before appending, so the resumed stream
    reads to its end and covers every frame; the recorded frames keep
    their masks from the interrupted run."""
    done = ["000000", "000001"]
    _seed_part(tmp_path, done)
    pkl_dir = tmp_path / "court" / "segm_mask"
    pkl_dir.mkdir(parents=True)
    with open(pkl_dir / "data.pkl", "wb") as f:
        for n in done:
            pickle.dump([n, b"fake-png-from-interrupted-run"], f)
        f.write(b"\x80\x04\x95partial-frame-2")   # torn mid-write
    run(workspace, tmp_path, extra=["--resume", "--req_outputs", "theta,segm_mask",
                                    "--mask_save_format", "pickle"])
    masks = {}
    with open(pkl_dir / "data.pkl", "rb") as f:
        try:
            while True:
                name, buf = pickle.load(f)     # raises if the stream is corrupt
                masks[name] = buf
        except EOFError:
            pass
    assert set(masks) == {f"{i:06d}" for i in range(N_FRAMES)}
    assert masks["000000"] == b"fake-png-from-interrupted-run"
    assert masks["000005"].dtype == np.uint8 and masks["000005"][:8, 0].tobytes() == \
        b"\x89PNG\r\n\x1a\n"


def test_resume_reproduces_the_uninterrupted_run(workspace, tmp_path):
    """Part JSONL with the first frames' real records and a torn line, the
    mask stream cut mid-record: the resumed run predicts the rest, and its
    merged JSON and mask streams equal those of a run never interrupted."""
    req = ["--req_outputs", "theta,consistency,poi,warp_mask", "--mask_save_format", "pickle"]
    ref = tmp_path / "ref"
    run(workspace, ref, extra=req + ["--resume"])  # --resume without a part: fresh
    full = _frames(ref / "game1_court.json")
    dst = tmp_path / "resumed"
    os.makedirs(dst / "court" / "warp_mask")
    with open(dst / "game1_court_processing.json", "w") as f:
        for i in range(4):
            f.write(json.dumps({f"{i:06d}": full[f"{i:06d}"]}) + "\n")
        f.write('{"000004": {"sco')
    stream = open(ref / "court" / "warp_mask" / "data.pkl", "rb").read()
    with open(dst / "court" / "warp_mask" / "data.pkl", "wb") as f:
        f.write(stream[: len(stream) * 5 // 6 + 7])     # through frame 4, torn
    assert run(workspace, dst, extra=req + ["--resume"])["frames"] == 2
    assert _frames(dst / "game1_court.json") == full

    def records(path):
        out = []
        with open(path, "rb") as f:
            while True:
                try:
                    out.append(pickle.load(f))
                except EOFError:
                    return {n: b.tobytes() for n, b in out}

    assert records(dst / "court" / "warp_mask" / "data.pkl") == \
        records(ref / "court" / "warp_mask" / "data.pkl")


def test_resume_video_prefix_skip(workspace, tmp_path):
    """Video: the contiguous done prefix is skipped (the capture seeks to
    the first frame not recorded)."""
    cv2 = pytest.importorskip("cv2")
    video_dir = tmp_path / "mygame"
    video_dir.mkdir()
    video = str(video_dir / "clip.mp4")
    wr = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 10, (W, H))
    rng = np.random.RandomState(1)
    for _ in range(7):
        wr.write(rng.randint(0, 255, (H, W, 3), dtype=np.uint8))
    wr.release()
    dst = tmp_path / "out"
    ref = tmp_path / "ref"
    run(workspace, ref, source=["--video_path", video])
    full = _frames(ref / "mygame_court.json")
    assert sorted(full) == [f"{i:06d}" for i in range(7)]
    _seed_part(dst, [f"{i:06d}" for i in range(3)], game="mygame")
    stats = run(workspace, dst, extra=["--resume"], source=["--video_path", video])
    assert stats["frames"] == 4
    frames = _frames(dst / "mygame_court.json")
    assert len(frames) == 7
    for i in range(3):
        assert frames[f"{i:06d}"]["theta"] == [SENTINEL]
    for i in range(3, 7):
        assert frames[f"{i:06d}"] == full[f"{i:06d}"]
