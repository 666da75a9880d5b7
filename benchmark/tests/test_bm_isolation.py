"""What a run may load and write, and the device trace's arithmetic."""
import ast
import json
import os
import subprocess
import sys

import pytest

import devtrace
import harness
from conftest import BENCH, REPO

PORT = "sports_field_homography_tpu_torch"


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules({PORT: 1, PORT + ".ops": 1, "numpy": 1}) == []
    assert harness.forbidden_modules({"jax.numpy": 1, "flax": 1}) == ["flax", "jax"]
    assert harness.forbidden_modules({"sports_field_homography_tpu.models": 1}) == [
        "sports_field_homography_tpu"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_reference_imports_nothing_of_the_port():
    allowed = {"__future__", "contextlib", "numpy", "torch", "reference"}
    for path in (BENCH / "reference").glob("*.py"):
        assert set(_imports(path)) <= allowed, path
    code = ("import sys; sys.path.insert(0, %r); import reference.model, reference.ops, "
            "reference.lowp; print(sorted({m.split('.')[0] for m in sys.modules}))" % str(BENCH))
    mods = json.loads(subprocess.run([sys.executable, "-c", code], capture_output=True,
                                     text=True, check=True).stdout.replace("'", '"'))
    assert PORT not in mods and not set(mods) & harness.FORBIDDEN


def test_only_program_py_imports_the_port():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        names = set(_imports(path))
        assert not names & harness.FORBIDDEN, path
        if PORT in names:
            assert path.name == "program.py", path


def test_nothing_reads_the_jax_benchmark():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        assert "bench.py" not in text and "BASELINE" not in text and "BENCH_r" not in text


def test_a_driven_run_loads_no_jax_and_writes_nothing_shared(tmp_path):
    code = f"""
import sys, json
sys.path[:0] = [{str(BENCH / 'tests')!r}, {str(BENCH)!r}, {str(REPO)!r}]
import harness
watch = harness.WriteWatch()
from conftest import tiny_run, driver_of
cell, r = tiny_run("flagship.predict.b32", seconds=0.5)
driver_of(cell).run(r)
print(json.dumps({{"forbidden": harness.forbidden_modules(), "writes": watch.new_entries(),
                  "correct": r.correct, "port": "{PORT}" in sys.modules}}))
"""
    env = dict(os.environ, TMPDIR=str(tmp_path), HOME=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"forbidden": [], "writes": [], "correct": True, "port": True}


def test_the_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "flagship.predict.b32", "--seed", str(2 ** 31 + 7), "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "does not run on the CPU" in out.stderr


class _FakeTrace(devtrace.DeviceTrace):
    def __init__(self, events):
        super().__init__()
        self.t_marker = 1_000
        self.events = events

    def _device_events(self):
        return self.events


def test_trace_reduction_busy_groups_and_idle_by_span():
    groups = devtrace.load_groups(BENCH / "kernel_groups")
    off = 5_000_000 - 1_000            # the marker ran at trace time 5 ms, host time 1 us
    ev = [(5_000_000, 5_000_100, "void at::spin_kernel(long)"),
          (off + 10_000, off + 20_000, "void conv3x3_sm90_kernel<1>(Params)"),
          (off + 15_000, off + 30_000, "Memcpy HtoD (Pinned -> Device)"),
          (off + 50_000, off + 60_000, "wgrad3x3_sm90_kernel"),
          (off + 60_000, off + 70_000, "cudnn::engines::foo"),
          (off + 95_000, off + 120_000, "void conv3x3_sm90_kernel<1>(Params)")]
    spans = devtrace.Spans()
    spans.add("h2d", 0, 40_000)
    spans.add("wait", 40_000, 100_000)
    t = _FakeTrace(ev).reduce(0, 100_000, groups, spans)
    assert t["window_s"] == pytest.approx(100e-6)
    assert t["busy_s"] == pytest.approx((20_000 + 20_000 + 5_000) * 1e-9)
    assert t["kernels"] == 4
    assert t["groups"]["k2_conv3x3_tc"] == pytest.approx(15e-6)
    assert t["groups"]["k5_wgrad3x3_tc"] == pytest.approx(10e-6)
    assert t["groups"]["cudnn_cublas"] == pytest.approx(10e-6)
    assert t["op_seconds"] == pytest.approx({"conv3x3": 15e-6, "wgrad3x3": 10e-6})
    assert t["idle_by_span"] == pytest.approx({"h2d": 10e-6, "wait": 45e-6})
