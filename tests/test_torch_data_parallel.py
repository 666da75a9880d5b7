"""Data-parallel training of the port: two gloo ranks on the CPU (float32)
against the port in one process and against the JAX package.

* The JAX package's multi-step contract (``parallel/distributed.py:198``),
  through the port's ``python -m ...parallel.distributed --smoke`` harness:
  4 SGD steps, equal parameter digests on both ranks, a bit-equal resume
  from a mid-run checkpoint, and parameters within 1e-5 of one process on
  the full batches (JAX measured ~7e-6; the difference is reduction order).
* One RMSprop step of two ranks against JAX's single-device
  ``make_train_step(masked_bn=True)`` at batch 6: a full batch split 3 + 3,
  and a true tail of 5 split 3 + 2 (padded to 6 for JAX); and ``grad_accum
  2`` on two ranks against one: ``tests/test_train_step_parity.py``'s bounds
  (losses rtol 2e-3 / atol 1e-4, consistency 1e-2 / 1e-3; gradients
  rel-L2 2e-2; post-step params atol 2.5e-3; running stats rtol 1e-3 /
  atol 1e-5).
* The synced DoubleConv (one input, two inputs, the stem) and the ResNet
  block alone, split 3 + 2, against one rank on the concatenated batch:
  outputs and input gradients to 1e-5, parameter gradients summed over
  the ranks equal to one rank's (a second reduction of dgamma / dbeta
  doubles them), running variances with the global n - 1.
* The train CLI: ``--num_devices 2`` against one device; ``train_net``
  over two epochs on a tiny set beside the JAX CLI's (the validation
  cadence and metrics, the consistency gate, the epoch checkpoints); a
  SIGTERM that reaches one rank, then ``--resume``; a rank that dies; the
  refusals.

Every child process has its own timeout (``CHILD_TIMEOUT``) and one
thread.
"""
import json
import os
import re
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from sports_field_homography_tpu.data.assets import open_court_poi as jax_poi
from sports_field_homography_tpu.data.assets import open_court_template as jax_template
from sports_field_homography_tpu.ops.interval_warp import build_interval_table
from sports_field_homography_tpu.train.loop import LossConfig as JaxLossConfig
from sports_field_homography_tpu.train.loop import init_train_state, make_train_step
from sports_field_homography_tpu.train.optim import make_optimizer as jax_optimizer
from sports_field_homography_tpu_torch.compat.jax_params import state_dict_from_jax
from sports_field_homography_tpu_torch.parallel.distributed import free_port

from test_torch_tail_pad import (COURT, POI, H, W, assert_step_matches, jax_model,
                                 make_batch, pad_batch, port_model)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 120
# the harness's losses (the JAX harness's: CE, MSE, RRMSE, CE, default lambdas)
HARNESS_LOSSES = dict(seg_loss="CE", rec_loss="MSE", reproj_loss="RRMSE",
                      consist_loss="CE", consist_start_iter=0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The in-process runs here on two threads, as the rank processes on
    one: the suite runs several test files at once on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)


def _ranks(argv_of, n=2, timeout=CHILD_TIMEOUT):
    """Start ``n`` processes (``argv_of(rank)``) and wait for all; returns
    their outputs, asserting every one exited 0."""
    procs = [subprocess.Popen(argv_of(i), cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n=====\n".join(o[-4000:] for o in outs)
    return outs


def _harness(*extra):
    port = str(free_port())
    return _ranks(lambda i: [sys.executable, "-m",
                             "sports_field_homography_tpu_torch.parallel.distributed",
                             "--smoke", str(i), "2", port, "--device", "cpu"] + list(extra))


def _fields(line):
    return dict(kv.split("=", 1) for kv in line.split()[1:])


def _line(out, tag):
    return _fields(next(ln for ln in out.splitlines() if ln.startswith(tag)))


def test_multistep_contract():
    outs = _harness("--steps", "4")
    a, b = (_line(o, "DIST_MULTISTEP") for o in outs)      # rank 0 runs the reference
    assert a["backend"] == b["backend"] == "gloo"
    assert a["digest"] == b["digest"]
    assert a["resume_bit_equal"] == b["resume_bit_equal"] == "True"
    assert float(a["maxabs"]) <= 1e-5, a
    print(f"\ntwo ranks vs one process after 4 SGD steps: params max-abs {a['maxabs']}")


def test_grad_accum_two_ranks_against_one():
    outs = _harness("--grad_accum", "2")
    a, b = (_line(o, "DIST_SMOKE") for o in outs)
    assert a["digest"] == b["digest"]
    assert float(a["loss"]) == pytest.approx(float(a["local"]), rel=2e-3, abs=1e-4)
    assert float(a["grad_rel_l2"]) < 2e-2
    assert float(a["params_maxabs"]) <= 2.5e-3
    assert float(a["stats_vs_bound"]) <= 1.0


# --- against JAX --------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_step():
    """JAX's masked program at batch 6 (one compile for both tests: on a
    full batch its valid rows are all the rows), from the seeded variables
    of the well-posed case of ``tests/test_torch_train_step.py``."""
    model, variables = jax_model(3)
    optimizer = jax_optimizer("RMSprop", 1e-4, 1e-8, grad_clip_value=0.1)
    losses = JaxLossConfig(**HARNESS_LOSSES, batch_size=6)
    step = jax.jit(make_train_step(model, optimizer, losses, with_grads=True,
                                   masked_bn=True))
    court = jax_template(COURT, 4, size=(W, H))
    consts = (jnp.asarray(court), jnp.asarray(jax_poi(POI, 1)), build_interval_table(court))

    def run(batch):
        return jax.device_get(step(init_train_state(variables, optimizer),
                                   pad_batch(batch, 6), *consts))

    return variables, run


def _two_rank_step(tmp_path, variables, batch):
    """The harness's RMSprop step on two ranks from ``variables`` on
    ``batch``; returns rank 0's logs, gradients and a port model holding its
    state, after checking both ranks hold one state."""
    torch.save(state_dict_from_jax(variables), tmp_path / "init.pth")
    np.savez(tmp_path / "batch.npz", **batch)
    _harness("--size", str(W), str(H), "--load", str(tmp_path / "init.pth"),
             "--batch", str(tmp_path / "batch.npz"), "--out", str(tmp_path / "out"))
    r0, r1 = (torch.load(tmp_path / "out" / f"rank{i}.pt") for i in (0, 1))
    assert r0["digest"] == r1["digest"]
    for name, v in r0["state"].items():
        assert torch.equal(v, r1["state"][name]), name
    model = port_model(variables)
    model.load_state_dict(r0["state"])
    return model, r0["logs"], r0["grads"]


def test_rmsprop_step_two_ranks_against_jax(jax_step, tmp_path):
    """A full batch of 6, 3 + 3."""
    variables, run = jax_step
    batch = make_batch(6, 4)
    new_state, logs_j, grads_j = run(batch)
    port, logs, grads = _two_rank_step(tmp_path, variables, batch)
    assert_step_matches(port, logs, grads, new_state, logs_j, grads_j)


def test_true_tail_split_against_jax_masked_step(jax_step, tmp_path):
    """A tail of 5 over two ranks is 3 + 2 with the global counts: JAX's
    masked program on the 5 padded to 6 computes the same step."""
    variables, run = jax_step
    tail = make_batch(5, 4)
    new_state, logs_j, grads_j = run(tail)
    port, logs, grads = _two_rank_step(tmp_path, variables, tail)
    assert_step_matches(port, logs, grads, new_state, logs_j, grads_j)


# --- the synced BatchNorm layers alone ------------------------------------------

_LAYERS = textwrap.dedent("""
    import copy, json, sys, torch
    from sports_field_homography_tpu_torch.models.layers import set_bn_sync
    from sports_field_homography_tpu_torch.models.resnet import BasicBlock
    from sports_field_homography_tpu_torch.models.unet import DoubleConv
    from sports_field_homography_tpu_torch.parallel.distributed import (
        initialize_distributed, process_slice)

    rank, port = int(sys.argv[1]), sys.argv[2]
    r = initialize_distributed("127.0.0.1:" + port, 2, rank, torch.device("cpu"))
    N = 5
    lo, n = process_slice(N, rank, 2)
    torch.manual_seed(0)
    cases = {"one input": (DoubleConv(8, 16), (N, 6, 5, 8), None, (N, 6, 5, 16)),
             "two inputs": (DoubleConv(16, 16), (N, 6, 5, 8), (N, 6, 5, 8), (N, 6, 5, 16)),
             "stem": (DoubleConv(3, 16), (N, 6, 5, 3), None, (N, 6, 5, 16)),
             "resnet block": (BasicBlock(8, 16, 2, True), (N, 8, 6, 5), None, (N, 16, 3, 3))}
    report = {}
    for name, (mod, xs, x2s, gs) in cases.items():
        x, g = torch.randn(xs), torch.randn(gs)
        x2 = None if x2s is None else torch.randn(x2s)
        one = mod.train()
        twin = copy.deepcopy(mod)
        def run(m, xx, xx2, gg, sync):
            set_bn_sync(m, sync)
            xx = xx.clone().requires_grad_(True)
            args = (xx,) if xx2 is None else (xx, xx2.clone().requires_grad_(True))
            if sync is not None:
                sync.set_batch(xx.shape[0])
            out = m(*args)
            (out * gg).sum().backward()
            return out.detach(), [a.grad for a in args]
        out1, dx1 = run(one, x, x2, g, None)
        sl = slice(lo, lo + n)
        out2, dx2 = run(twin, x[sl], None if x2 is None else x2[sl], g[sl], r)
        err = {"out": float((out2 - out1[sl]).abs().max()),
               "dx": max(float((b - a[sl]).abs().max()) for a, b in zip(dx1, dx2))}
        p1, p2 = dict(one.named_parameters()), dict(twin.named_parameters())
        err["grads"] = max(float((r.all_reduce_(p2[k].grad.clone()) - p1[k].grad).abs().max()
                                 / p1[k].grad.abs().max().clamp_min(1e-30))
                           for k in p1 if not k.endswith((".0.bias", ".3.bias")))
        gam = [f"{m}.{p}" for m, mm in one.named_modules()
               if isinstance(mm, torch.nn.BatchNorm2d) for p in ("weight", "bias")]
        err["dgamma_ratio"] = max(float((r.all_reduce_(p2[k].grad.clone()).abs().sum()
                                         / p1[k].grad.abs().sum())) for k in gam)
        b1, b2 = dict(one.named_buffers()), dict(twin.named_buffers())
        err["running"] = max(float((b2[k].float() - b1[k].float()).abs().max())
                             for k in b1 if "running" in k)
        err["tracked"] = all(int(b2[k]) == int(b1[k]) == 1 for k in b1 if "tracked" in k)
        report[name] = err
    print("LAYERS " + json.dumps(report), flush=True)
    r.close()
""")


def test_synced_batchnorm_layers_against_one_rank(tmp_path):
    script = tmp_path / "layers.py"
    script.write_text(_LAYERS)
    port = str(free_port())
    outs = _ranks(lambda i: [sys.executable, str(script), str(i), port])
    for out in outs:
        report = json.loads(next(ln for ln in out.splitlines()
                                 if ln.startswith("LAYERS "))[len("LAYERS "):])
        assert set(report) == {"one input", "two inputs", "stem", "resnet block"}
        for name, err in report.items():
            assert err["out"] <= 1e-5 and err["dx"] <= 1e-5, (name, err)
            assert err["grads"] <= 1e-5, (name, err)
            # the ranks' dgamma / dbeta add up to one rank's: 1, not 2
            assert abs(err["dgamma_ratio"] - 1.0) <= 1e-5, (name, err)
            assert err["running"] <= 1e-6 and err["tracked"], (name, err)


# --- the train CLI ---------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_set(tmp_path_factory):
    from sports_field_homography_tpu_torch.data.synthetic import write_synthetic_dataset

    root = tmp_path_factory.mktemp("dp_synth")
    # 4 validation frames, a whole batch: the JAX CLI's validation divides the
    # reprojection sums by the padded batch's length (its loader wrapper drops
    # ``num_valid``), so on a padded tail it reads low by the padding's share
    write_synthetic_dataset(str(root), 6, 4, COURT, POI, size=(W, H), seed=1)
    return root


def _conf(tiny_set, path, cp_dir, **over):
    conf = dict(img_dir=str(tiny_set / "frames"), mask_dir=str(tiny_set / "masks"),
                anno_dir=str(tiny_set / "anno"), anno_keys=["poi", "reproj_mse"],
                val_names=["val_game"], court_img=COURT, court_poi=POI, court_size=[W, H],
                cp_dir=str(cp_dir) + "/", epochs=1, batchsize=4, target_size=[W, H],
                unet_size=[W, H], warp_size=[W, H], resnet_name="resnet18",
                weight_decay=0.0, val_step_n=1, opt="SGD", lr=1e-3,
                compute_dtype="float32", device="cpu", data_seed=3, **HARNESS_LOSSES)
    conf.update(over)
    path.write_text(json.dumps(conf))
    return str(path)


def _train_cli(*argv, hosts=None, timeout=CHILD_TIMEOUT):
    cmd = [sys.executable, "-m", "sports_field_homography_tpu_torch.cli.train"] + list(argv)
    if hosts is None:
        out = subprocess.run(cmd, cwd=REPO, env=_env(), capture_output=True, text=True,
                             timeout=timeout)
        assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
        return out.stdout
    port = str(free_port())
    return _ranks(lambda i: cmd + ["--num_hosts", "2", "--host_id", str(i),
                                   "--coordinator", f"127.0.0.1:{port}"], timeout=timeout)


def _validations(log_text):
    return re.findall(r"\[Validation, epoch: (\d+) of \d+, step: (\d+)\] Tot: ([-\d.e]+), "
                      r"seg: ([-\d.e]+), rec: ([-\d.e]+), uv: ([-\d.e]+), "
                      r"reproj: ([-\d.e]+)\(([-\d.e]+)\)px, cons: ([-\d.e]+)", log_text)


def _params_and_stats(a, b):
    """(max-abs over parameters, max over running stats of |a - b| / (1e-5 +
    1e-3 |b|)) of two state dicts."""
    params = max(float((a[k].double() - b[k].double()).abs().max())
                 for k in b if b[k].is_floating_point() and "running" not in k)
    stats = max(float(((a[k].double() - b[k].double()).abs()
                       / (1e-5 + 1e-3 * b[k].double().abs())).max())
                for k in b if "running" in k)
    return params, stats


def test_train_cli_two_ranks_against_one(tiny_set, tmp_path):
    """``--num_devices 2`` (two spawned gloo ranks) against one device: an
    epoch of SGD, a full batch of 4 (2 + 2) and the tail of 2 (1 + 1), then
    a validation.  Within reduction order: params 5e-5, running stats rtol
    1e-3 / atol 1e-5, validation metrics rtol 1e-4."""
    from sports_field_homography_tpu_torch.cli import train as train_cli

    one, two = tmp_path / "one", tmp_path / "two"
    hist = train_cli.main(["-c", _conf(tiny_set, tmp_path / "one.json", one / "cp",
                                       val_step_n=2)], num_data_workers=1)
    assert len(hist["steps"]) == 2
    out = _train_cli("-c", _conf(tiny_set, tmp_path / "two.json", two / "cp", val_step_n=2),
                     "--num_devices", "2")
    assert "backend gloo" in out
    assert sorted(os.listdir(two / "cp")) == ["CP_epoch1.pth", "conf.yaml"]
    params, stats = _params_and_stats(torch.load(two / "cp" / "CP_epoch1.pth"),
                                      torch.load(one / "cp" / "CP_epoch1.pth"))
    assert params <= 5e-5 and stats <= 1.0, (params, stats)
    v1 = _validations((one / "train.txt").read_text())
    v2 = _validations((two / "train.txt").read_text())
    assert [v[:2] for v in v1] == [v[:2] for v in v2] == [("1", "2")]
    np.testing.assert_allclose(np.float64(v1[0][2:]), np.float64(v2[0][2:]), rtol=1e-4,
                               atol=1e-6)


# the SIGTERM and dead-rank runs: the CLI's control flow on the STN alone
# (no UNet), two epochs of two steps
STN_ONLY = dict(use_unet=False, resnet_input="img", epochs=2, val_step_n=100)


@pytest.fixture(scope="module")
def one_batch_set(tmp_path_factory):
    from sports_field_homography_tpu_torch.data.synthetic import write_synthetic_dataset

    root = tmp_path_factory.mktemp("dp_synth_one_batch")
    write_synthetic_dataset(str(root), 4, 4, COURT, POI, size=(W, H), seed=2)
    return root


def test_train_loop_two_epochs_beside_jax(one_batch_set, tmp_path):
    """ROADMAP queue 3, item 1: the port's ``train_net`` on one rank and on
    two, beside the JAX CLI's, from one checkpoint, over 2 epochs with a
    validation after every step.  An epoch is one batch of all 4 frames:
    the JAX CLI orders a game's frames as the file system lists them and
    the port sorts them, so only a whole-set batch is the same batch on
    both.  At lr 1e-9 the parameters barely move and the running
    statistics carry the run (BN momentum does not depend on the rate).
    The consistency gate opens at step 1 (``consist_start_iter`` 4, batch
    4).  Held: the validations' epochs and steps, their metrics (rtol 2e-3
    / atol 1e-4, reprojection included; the plateau scheduler steps on the
    reprojection error, and with patience 3 two validations cut the rate
    on no side: the rate-change lines agree), and every epoch checkpoint
    (params atol 2.5e-3, running stats rtol 1e-3 / atol 1e-5)."""
    from sports_field_homography_tpu.cli import train as jax_cli
    from sports_field_homography_tpu.utils.checkpoint import save_checkpoint as jax_save
    from sports_field_homography_tpu_torch.cli import train as train_cli
    from sports_field_homography_tpu_torch.compat.flax_msgpack import load_msgpack

    init = tmp_path / "init" / "CP_epoch0.msgpack"      # one start for every side
    init.parent.mkdir()
    jax_save(str(init), jax_model(3)[1])
    over = dict(epochs=2, lr=1e-9, consist_start_iter=4, load=str(init))
    jax_cp = tmp_path / "jax" / "cp"
    jax_conf = json.loads(open(_conf(one_batch_set, tmp_path / "jax.json", jax_cp,
                                     **over)).read())
    jax_conf.pop("device")
    # YAML, whose reader takes "1e-09" (JSON's spelling) for a string
    (tmp_path / "jax.yaml").write_text(yaml.safe_dump(jax_conf))
    jax_cli.main(["-c", str(tmp_path / "jax.yaml")])
    one = tmp_path / "one" / "cp"
    hist = train_cli.main(["-c", _conf(one_batch_set, tmp_path / "one.json", one, **over)],
                          num_data_workers=1)
    cons = [s["Cons_loss"] for s in hist["steps"]]
    assert cons[0] == 0.0 and all(c > 0 for c in cons[1:]), cons
    two = tmp_path / "two" / "cp"
    _train_cli("-c", _conf(one_batch_set, tmp_path / "two.json", two, **over), hosts=2)

    logs = {k: (tmp_path / k / "train.txt").read_text() for k in ("jax", "one", "two")}
    vals = {k: _validations(v) for k, v in logs.items()}
    changes = {k: re.findall(r"Learning rate has been changed: ([\d.e-]+)", v)
               for k, v in logs.items()}
    for k, v in vals.items():
        assert [x[:2] for x in v] == [("1", "1"), ("2", "2")], (k, v)
        np.testing.assert_allclose(np.float64([x[2:] for x in v]),
                                   np.float64([x[2:] for x in vals["jax"]]),
                                   rtol=2e-3, atol=1e-4, err_msg=k)
        assert changes[k] == changes["jax"], changes
    for epoch in (1, 2):
        want = state_dict_from_jax(load_msgpack(str(jax_cp / f"CP_epoch{epoch}.msgpack")))
        for k in ("one", "two"):
            got = torch.load(tmp_path / k / "cp" / f"CP_epoch{epoch}.pth")
            for name, ref in want.items():
                if name.endswith("num_batches_tracked"):
                    continue
                g, r = got[name].double().numpy(), ref.double().numpy()
                if "running_" in name:
                    np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-5, err_msg=name)
                else:
                    np.testing.assert_allclose(g, r, atol=2.5e-3, err_msg=name)


def test_sigterm_to_one_rank_then_resume(tiny_set, tmp_path):
    """A SIGTERM that reaches rank 1 alone stops both ranks after the same
    step (the stop flag rides the gradient all-reduce); rank 0 saves, both
    exit 0, and ``--resume`` on two ranks finishes bit-equal to an
    uninterrupted two-rank run (gloo on the CPU is deterministic)."""
    ref = tmp_path / "ref" / "cp"
    _train_cli("-c", _conf(tiny_set, tmp_path / "ref.json", ref, **STN_ONLY), hosts=2)
    cp = tmp_path / "int" / "cp"
    conf = _conf(tiny_set, tmp_path / "int.json", cp, **STN_ONLY)
    port = str(free_port())
    cmd = [sys.executable, "-m", "sports_field_homography_tpu_torch.cli.train", "-c", conf,
           "--num_hosts", "2", "--coordinator", f"127.0.0.1:{port}", "--host_id"]
    procs = [subprocess.Popen(cmd + [str(i)], cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for i in range(2)]
    try:
        seen = ""
        deadline = time.monotonic() + CHILD_TIMEOUT
        while "step 1:" not in seen and time.monotonic() < deadline:
            seen += procs[1].stdout.readline()
        procs[1].send_signal(signal.SIGTERM)
        outs = [seen + procs[1].communicate(timeout=CHILD_TIMEOUT)[0],
                procs[0].communicate(timeout=CHILD_TIMEOUT)[0]]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n=====\n".join(o[-3000:] for o in outs)
    assert "Interrupt requested" in outs[0] and "Saved interrupt" in outs[1]
    sched = json.loads((cp / "last_state.sched.json").read_text())
    assert 0 < sched["epoch"] * 2 + sched["opt_steps_done"] < 4, sched

    out = _train_cli("-c", conf, "--resume", hosts=2)
    assert "Exact resume" in out[0]
    a, b = torch.load(cp / "CP_epoch2.pth"), torch.load(ref / "CP_epoch2.pth")
    assert all(torch.equal(a[k], b[k]) for k in b)


def test_a_dead_rank_fails_the_run(tiny_set, tmp_path):
    conf = _conf(tiny_set, tmp_path / "c.json", tmp_path / "cp", **dict(STN_ONLY, epochs=3))
    port = str(free_port())
    cmd = [sys.executable, "-m", "sports_field_homography_tpu_torch.cli.train", "-c", conf,
           "--num_hosts", "2", "--coordinator", f"127.0.0.1:{port}", "--host_id"]
    procs = [subprocess.Popen(cmd + [str(i)], cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for i in range(2)]
    try:
        seen = ""
        deadline = time.monotonic() + CHILD_TIMEOUT
        while "step 1:" not in seen and time.monotonic() < deadline:
            seen += procs[1].stdout.readline()
        procs[1].kill()
        t0 = time.monotonic()
        out = procs[0].communicate(timeout=CHILD_TIMEOUT)[0]
    finally:
        for p in procs:
            p.kill()
    assert procs[0].returncode != 0, out[-3000:]
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("extra,match", [
    (["--num_devices", "2", "--batchsize", "3"],
     "--batchsize 3 is not divisible by num_devices 2: data-parallel sharding needs "
     "equal per-device shards. Use e.g. --batchsize 2 or 4."),
    (["--num_devices", "2", "--data_seed", "-1"], "needs a seeded --data_seed"),
    (["--num_devices", "2", "--device", "cuda"], "needs 2 CUDA devices"),
])
def test_train_cli_refuses_before_any_rank_starts(tmp_path, extra, match):
    from sports_field_homography_tpu_torch.cli import train as train_cli

    base = ["--img_dir", "f", "--mask_dir", "m", "--anno_dir", "a", "--cp_dir",
            str(tmp_path), "--device", "cpu", "--batchsize", "4"]
    with pytest.raises(SystemExit, match=re.escape(match)):
        train_cli.main(base + extra)
