"""The port's predict CLI split over hosts and over devices (CPU, gloo,
float32), against itself in one process and against the JAX CLI.

Eight tiny PNG frames and seeded weights, as ``tests/test_torch_predict_cli.py``
makes them.  ``--num_hosts 2`` runs two CLI processes that meet at a TCP
store: each predicts its contiguous slice of the frames (4 + 4) into its
own part files, and host 0 merges them after a barrier.  The merged
``{game}_court.json`` must be the one-process file frame for frame (the
frames of a slice go through the same eval-mode program), and within
``docs/PARITY.md`` of the JAX CLI (theta 2e-4, score 1e-3 plus the JSON's
rounding); the merged ``data.pkl`` mask stream must hold the one-process
run's records.  ``--resume`` finishes a host's torn part.  ``--num_devices
2`` (two CPU replicas in one process) equals one device.
"""
import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from sports_field_homography_tpu.cli.predict import process as jax_process
from sports_field_homography_tpu.compat.torch_export import save_torch_checkpoint
from sports_field_homography_tpu.utils.checkpoint import save_checkpoint
from sports_field_homography_tpu_torch.cli.predict import process as port_process
from sports_field_homography_tpu_torch.parallel.distributed import free_port

from test_torch_predict_cli import COURT, POI, H, W, _seeded_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 8
CHILD_TIMEOUT = 120


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The in-process runs here on two threads, as the rank processes on
    one: the suite runs several test files at once on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_predict_mh")
    img_dir = root / "game1"
    img_dir.mkdir()
    rng = np.random.default_rng(1)
    for i in range(N_FRAMES):
        Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(
            img_dir / f"{i:06d}.png")
    cp_dir = root / "ckpt" / "model_mh"
    cp_dir.mkdir(parents=True)
    conf = {"target_size": [W, H], "unet_size": [W, H], "warp_size": [W, H],
            "court_size": [W, H], "mask_classes": 4, "resnet_name": "resnet18",
            "resnet_input": "img+mask", "use_unet": True, "use_resnet": True}
    with open(cp_dir / "conf.yaml", "w") as f:
        yaml.safe_dump(conf, f)
    variables = _seeded_variables(2)
    save_checkpoint(str(cp_dir / "CP_epoch1.msgpack"), variables)
    save_torch_checkpoint(str(cp_dir / "CP_epoch1.pth"), variables)
    return img_dir, cp_dir


def _argv(img_dir, ckpt, dst, outputs="theta,consistency,segm_mask"):
    return ["--img_dir", str(img_dir), "--load", str(ckpt), "--dst_dir", str(dst),
            "--req_outputs", outputs, "--mask_save_format", "pickle",
            "--batchsize", "2", "--compute_dtype", "float32",
            "--court_img", COURT, "--court_poi", POI]


def _two_hosts(argv):
    """The CLI as host 0 and host 1 of two, in two processes."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sports_field_homography_tpu_torch.cli.predict"] + argv
        + ["--device", "cpu", "--coordinator", f"127.0.0.1:{port}", "--num_hosts", "2",
           "--host_id", str(i)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n=====\n".join(o[-3000:] for o in outs)
    return outs


def _stream(path):
    recs = {}
    with open(path, "rb") as f:
        while True:
            try:
                name, buf = pickle.load(f)
            except EOFError:
                return recs
            recs[name] = np.asarray(buf).tobytes()


@pytest.fixture(scope="module")
def single(workspace, tmp_path_factory):
    img_dir, cp_dir = workspace
    dst = tmp_path_factory.mktemp("single")
    port_process(_argv(img_dir, cp_dir / "CP_epoch1.pth", dst) + ["--device", "cpu"],
                 num_data_workers=1)
    return dst


def _assert_same_records(got_dir, want_dir, n_frames=N_FRAMES):
    got = json.load(open(got_dir / "game1_court.json"))
    want = json.load(open(want_dir / "game1_court.json"))
    assert set(got) == set(want) and len(want) == n_frames + 1
    assert got["model"] == want["model"] == "model_mh"
    for name in (k for k in want if k != "model"):
        assert got[name] == want[name], name
    assert (_stream(got_dir / "court" / "segm_mask" / "data.pkl")
            == _stream(want_dir / "court" / "segm_mask" / "data.pkl"))


@pytest.fixture(scope="module")
def two_hosts(workspace, tmp_path_factory):
    """The CLI as two hosts; returns (the merged run's directory, the two
    hosts' outputs)."""
    img_dir, cp_dir = workspace
    dst = tmp_path_factory.mktemp("multi")
    return dst, _two_hosts(_argv(img_dir, cp_dir / "CP_epoch1.pth", dst))


def test_two_hosts_merge_equals_one_process(two_hosts, single):
    dst, outs = two_hosts
    assert "host 0: frames [0, 4)" in outs[0] and "host 1: frames [4, 8)" in outs[1]
    assert "backend gloo" in outs[0]
    _assert_same_records(dst, single)
    leftovers = [p for p in os.listdir(dst) if ".h" in p]
    leftovers += [p for p in os.listdir(dst / "court" / "segm_mask") if ".h" in p]
    assert not leftovers, leftovers


def test_two_hosts_within_parity_of_the_jax_cli(workspace, two_hosts, tmp_path):
    img_dir, cp_dir = workspace
    jax_dst = tmp_path / "jax"
    jax_process(_argv(img_dir, cp_dir / "CP_epoch1.msgpack", jax_dst, "theta,consistency"))
    want = json.load(open(jax_dst / "game1_court.json"))
    got = json.load(open(two_hosts[0] / "game1_court.json"))
    assert set(got) == set(want)
    for name in (k for k in want if k != "model"):
        np.testing.assert_allclose(got[name]["theta"], want[name]["theta"], rtol=0,
                                   atol=2e-4)
        assert abs(got[name]["score"] - want[name]["score"]) <= 1e-3 + 1e-6


def test_resume_finishes_a_torn_part(workspace, single, tmp_path):
    """Host 1 died after writing two of its frames and half a third: its
    part JSONL ends in a torn line, its pickle part in a torn record.  The
    resumed run predicts only what each host lacks and merges the same
    result as one process."""
    img_dir, cp_dir = workspace
    dst = tmp_path / "resumed"
    want = json.load(open(single / "game1_court.json"))
    want_masks = _stream(single / "court" / "segm_mask" / "data.pkl")
    (dst / "court" / "segm_mask").mkdir(parents=True)
    done = ["000004", "000005"]
    with open(dst / "game1_court_processing.json.h1", "w") as f:
        for name in done:
            f.write(json.dumps({name: want[name]}) + "\n")
        f.write('{"000006": {"sco')
    with open(dst / "court" / "segm_mask" / "data.pkl.h1", "wb") as f:
        for name in done:
            pickle.dump([name, np.frombuffer(want_masks[name], np.uint8).reshape(-1, 1)], f)
        f.write(pickle.dumps(["000006", np.zeros((40, 1), np.uint8)])[:30])
    outs = _two_hosts(_argv(img_dir, cp_dir / "CP_epoch1.pth", dst) + ["--resume"])
    assert "--resume: 2 frames already in game1_court_processing.json.h1, 2 left" in outs[1]
    _assert_same_records(dst, single)


def test_num_devices_splits_each_batch(workspace, tmp_path):
    """Two devices take a batch of 2 as two shards of 1: the records equal
    the one-device run's at batch 1 (a CPU conv's sums depend on the
    batch it runs in, so batch 2 on one device differs in the last bits).
    On 4 of the frames."""
    img_dir, cp_dir = workspace
    sub = tmp_path / "game1"
    sub.mkdir()
    for name in sorted(os.listdir(img_dir))[:4]:
        shutil.copy(img_dir / name, sub / name)
    img_dir = sub
    one, two = tmp_path / "one_device", tmp_path / "two_devices"
    port_process(_argv(img_dir, cp_dir / "CP_epoch1.pth", one)
                 + ["--device", "cpu", "--batchsize", "1"], num_data_workers=1)
    port_process(_argv(img_dir, cp_dir / "CP_epoch1.pth", two)
                 + ["--device", "cpu", "--num_devices", "2"], num_data_workers=1)
    _assert_same_records(two, one, n_frames=4)


@pytest.mark.parametrize("extra,match", [
    (["--device", "cpu", "--num_devices", "2", "--batchsize", "3"],
     "--batchsize 3 is not divisible by num_devices 2"),
    (["--device", "cuda", "--num_devices", "2"], "needs 2 CUDA devices"),
    (["--device", "cpu", "--num_hosts", "2", "--host_id", "2",
      "--coordinator", "127.0.0.1:1"], "--host_id 2 is not in"),
])
def test_refuses_what_cannot_run(workspace, tmp_path, extra, match):
    img_dir, cp_dir = workspace
    with pytest.raises((SystemExit, ValueError), match=match):
        port_process(_argv(img_dir, cp_dir / "CP_epoch1.pth", tmp_path) + extra)
