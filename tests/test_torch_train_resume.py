"""The port's interrupt save and exact resume (CPU).

A real SIGTERM to a train CLI subprocess mid-epoch, with augmentation,
validation and async epoch checkpoints on (as JAX's
``tests/test_sigterm_interrupt.py`` does for the JAX CLI): the process
saves at its next point between steps and exits 0, leaving ``last.pth``,
``last_state.pth`` and ``last_state.sched.json``; ``--resume`` then
finishes the run with weights bit-identical to an uninterrupted run's.
Every child runs with the same thread count, so the CPU sums are
reproducible.  Also: the async saver writes the synchronous save's bytes
from a copy taken when it is called, an atomic write interrupted before its
rename leaves the old file intact, and a ``--data_seed -1`` resume warns
that its schedule is fresh.
"""
import json
import logging
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COURT = os.path.join(REPO, "assets", "mask_ncaa_v4_nc4_m_onehot.png")
POI = os.path.join(REPO, "assets", "template_ncaa_v4_points.json")
W, H = 64, 36
AUG = {"apperance": {"jitter": {"brightness": 0.35, "contrast": 0.35, "saturation": 0.25,
                                "hue": 0.25}, "blur": 5},
       "geometric": {"hflip": 0.5}}
CHILD = ("import sys\n"
         "sys.path.insert(0, sys.argv[1])\n"
         "from sports_field_homography_tpu_torch.cli.train import main\n"
         "main(sys.argv[2:])\n")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from sports_field_homography_tpu_torch.data.synthetic import write_synthetic_dataset

    root = tmp_path_factory.mktemp("resume_set")
    write_synthetic_dataset(str(root), 7, 2, COURT, POI, size=(W, H), seed=3)
    return root


def _conf(tmp_path, data, name):
    conf = dict(img_dir=str(data / "frames"), mask_dir=str(data / "masks"),
                anno_dir=str(data / "anno"), anno_keys=["poi", "reproj_mse"],
                val_names=["val_game"], court_img=COURT, court_poi=POI, court_size=[W, H],
                cp_dir=str(tmp_path / name) + "/", epochs=2, batchsize=3,
                target_size=[W, H], unet_size=[W, H], warp_size=[W, H],
                resnet_name="resnet18", seg_loss="focal", rec_loss="MSE",
                reproj_loss="RRMSE", consist_loss="focal", consist_start_iter=0,
                seg_lambda=1, rec_lambda=1, reproj_lambda=8, consist_lambda=1,
                weight_decay=1e-6, val_step_n=2, aug=AUG, async_ckpt=True,
                compute_dtype="float32", device="cpu")
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(conf))
    return str(path)


def _child(argv, out_path, signal_after=None):
    """The train CLI in a subprocess (two threads, so every child sums in
    the same order); with ``signal_after``, SIGTERM once that text is in
    its output.  Returns (exit code, output)."""
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    with open(out_path, "w") as out:
        p = subprocess.Popen([sys.executable, "-c", CHILD, REPO] + argv, cwd=REPO, env=env,
                             stdout=out, stderr=subprocess.STDOUT)
    try:
        if signal_after is not None:
            deadline = time.time() + 300
            while signal_after not in open(out_path).read():
                assert p.poll() is None and time.time() < deadline, open(out_path).read()
                time.sleep(0.05)
            p.send_signal(signal.SIGTERM)
        rc = p.wait(timeout=600)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    return rc, open(out_path).read()


def test_sigterm_then_resume_is_bit_identical(dataset, tmp_path):
    full = _conf(tmp_path, dataset, "full")
    rc, log = _child(["-c", full], tmp_path / "full.log")
    assert rc == 0, log[-3000:]

    stopped = _conf(tmp_path, dataset, "stopped")
    rc, log = _child(["-c", stopped], tmp_path / "stopped.log", signal_after="step 1:")
    assert rc == 0, log[-3000:]
    assert "Interrupt requested" in log and "Saved interrupt" in log, log[-3000:]
    cp = tmp_path / "stopped"
    for f in ("last.pth", "last_state.pth", "last_state.sched.json"):
        assert (cp / f).exists(), f
    sched = json.loads((cp / "last_state.sched.json").read_text())
    state = torch.load(cp / "last_state.pth", weights_only=True)
    assert sched == {"epoch": state["epoch"], "opt_steps_done": state["opt_steps_done"]}
    assert 1 <= state["step"] < 6 and state["opt_steps_done"] >= 1
    assert set(state) == {"model", "optimizer", "scheduler", "step", "epoch", "opt_steps_done"}
    assert not (cp / "CP_epoch2.pth").exists()

    rc, log = _child(["-c", stopped, "--resume"], tmp_path / "resumed.log")
    assert rc == 0, log[-3000:]
    assert f"Resumed full train state from {cp / 'last_state.pth'}" in log
    assert "Exact resume: epoch" in log
    for epoch in (1, 2):
        want = torch.load(tmp_path / "full" / f"CP_epoch{epoch}.pth", weights_only=True)
        got = torch.load(cp / f"CP_epoch{epoch}.pth", weights_only=True)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (epoch, k)


def _state(seed):
    from sports_field_homography_tpu_torch.models.resnet import ResNetSTN, resnet_models
    from sports_field_homography_tpu_torch.train.optim import make_optimizer, make_scheduler
    from sports_field_homography_tpu_torch.utils.checkpoint import train_state

    torch.manual_seed(seed)
    model = ResNetSTN(in_channels=3, **resnet_models["resnet18"])
    opt = make_optimizer("RMSprop", model.parameters(), 1e-3, 1e-6)
    sched = make_scheduler(opt)
    model(torch.rand(2, 32, 32, 3)).sum().backward()
    opt.step()
    sched.step(1.0)
    return model, train_state(model, opt, sched, 1, 0, 1)


def test_async_save_writes_the_sync_bytes(tmp_path):
    from sports_field_homography_tpu_torch.utils.checkpoint import (AsyncSaver, save_checkpoint,
                                                                    save_train_state)

    model, state = _state(0)
    save_checkpoint(str(tmp_path / "sync.pth"), model)
    save_train_state(str(tmp_path / "sync_state.pth"), state)
    saver = AsyncSaver()
    saver.save(str(tmp_path / "async.pth"), model.state_dict())
    saver.save(str(tmp_path / "async_state.pth"), state)
    with torch.no_grad():          # the saver took its copy when called
        for p in model.parameters():
            p.add_(1.0)
    saver.close()
    assert (tmp_path / "async.pth").read_bytes() == (tmp_path / "sync.pth").read_bytes()
    assert (tmp_path / "async_state.pth").read_bytes() == \
        (tmp_path / "sync_state.pth").read_bytes()
    assert not any(p.suffix == ".tmp" for p in tmp_path.iterdir())


def test_interrupted_atomic_write_keeps_the_old_file(tmp_path, monkeypatch):
    from sports_field_homography_tpu_torch.utils import checkpoint

    model, _ = _state(1)
    path = tmp_path / "CP_epoch1.pth"
    checkpoint.save_checkpoint(str(path), model)
    before = path.read_bytes()
    other, _ = _state(2)

    def interrupted(*_):
        raise KeyboardInterrupt

    monkeypatch.setattr(checkpoint.os, "replace", interrupted)
    with pytest.raises(KeyboardInterrupt):
        checkpoint.save_checkpoint(str(path), other)
    assert path.read_bytes() == before
    loaded = torch.load(path, weights_only=True)
    assert torch.equal(loaded["conv0.weight"], model.conv0.weight)


def test_unseeded_resume_warns_of_a_fresh_schedule(tmp_path, caplog):
    from sports_field_homography_tpu_torch.cli.train import _resume_sched
    from sports_field_homography_tpu_torch.utils.config import get_training_args

    (tmp_path / "last_state.sched.json").write_text(json.dumps({"epoch": 1,
                                                                "opt_steps_done": 2}))
    logger = logging.getLogger("resume_test")
    base = ["--cp_dir", str(tmp_path), "--resume"]
    with caplog.at_level(logging.WARNING, logger="resume_test"):
        assert _resume_sched(get_training_args(base + ["--data_seed", "-1"]), logger) is None
    assert "FRESH" in caplog.text
    assert _resume_sched(get_training_args(base), logger) == {"epoch": 1, "opt_steps_done": 2}
    assert _resume_sched(get_training_args(["--cp_dir", str(tmp_path)]), logger) is None
