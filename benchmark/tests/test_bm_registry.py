"""The harness finds everything by name: a new configuration, traffic mix,
metric and kernel group are files of their own plus entries in
BENCHMARK.json, and no other file changes."""
import json
import shutil
import time

import pytest

import counts
import harness
from conftest import BENCH, REPO, WORKLOADS, cut, driver_of


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_resolves(workload):
    cell = harness.resolve(REPO, workload)
    assert cell.driver_path.is_file()
    assert cell.limits, f"limits/{workload}.json is missing"
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for path in cell.metric_paths.values():
        assert callable(harness.load_module(path, "bm_reg_" + path.stem.replace(".", "_")).read)
    assert cell.chips == 1


def test_names_follow_the_contract():
    bench = harness.load_benchmark(REPO)
    names = ([c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    assert len(names) == len(set(names))
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(REPO).as_posix()
        assert all(ch.isalnum() or ch in "_.-/" for ch in rel), rel
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        for w in m["workloads"]:
            cell = harness.resolve(REPO, w)
            assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_a_new_config_traffic_metric_and_group_need_no_edit(tmp_path):
    root = tmp_path / "repo"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    bench_dir = root / "benchmark"
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}

    cfg = json.loads((bench_dir / "configs" / "flagship.json").read_text())
    cfg["model"]["resnet_name"] = "resnet18"
    (bench_dir / "configs" / "flagship-r18.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench_dir / "traffic" / "predict.b32.json").read_text())
    (bench_dir / "traffic" / "predict.b8.json").write_text(json.dumps(dict(traffic, batch=8)))
    (bench_dir / "metrics" / "kernels_per_batch.predict.py").write_text(
        "def read(r):\n    return r.counters.get('units_issued')\n")
    (bench_dir / "kernel_groups" / "new_kernel.json").write_text(
        json.dumps({"order": 5, "patterns": ["my_new_kernel"], "op": "conv3x3"}))
    (bench_dir / "limits" / "flagship-r18.predict.b8.json").write_text(
        json.dumps({"limits": {"theta_gap": 1.0, "score_gap": 1.0}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "flagship-r18", "source": "x",
                             "file": "benchmark/configs/flagship-r18.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "flagship-r18.predict.b8", "config": "flagship-r18",
                               "traffic": "predict.b8", "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("flagship-r18.predict.b8")
    bench["per_layer"].append({"name": "kernels_per_batch.predict", "unit": "launches",
                               "better": "lower", "source": "device_trace", "layer": "x",
                               "moves": "predict_frames_s",
                               "workloads": ["flagship-r18.predict.b8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.resolve(root, "flagship-r18.predict.b8", root=bench_dir)
    assert cell.config["model"]["resnet_name"] == "resnet18"
    assert cell.traffic["batch"] == 8 and cell.driver_path.name == "predict.py"
    assert cell.limits == {"theta_gap": 1.0, "score_gap": 1.0}
    assert [m["name"] for m in cell.end_to_end] == ["predict_frames_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["kernels_per_batch.predict"]
    assert cell.groups[0][0] == "new_kernel"
    run = harness.Run(cell, 1, 1.0, True, "cpu", 0)
    run.counters["units_issued"] = 7
    assert run.per_layer_metrics() == {"kernels_per_batch.predict":
                                       {"value": 7.0, "unit": "launches"}}
    # the old cells still resolve, and no file that was there changed
    assert harness.resolve(root, "flagship.predict.b32", root=bench_dir).traffic == traffic
    changed = [p for p, data in before.items() if (root / p).read_bytes() != data]
    assert changed == [p for p in before if p.name == "BENCHMARK.json"]


def test_every_metric_reader_reads_nothing_from_an_empty_run():
    """A reader with nothing to read returns None: no trace, no counters,
    no peaks; never 0 for a share."""
    cell = harness.resolve(REPO, WORKLOADS[0])
    run = harness.Run(cell, 1, 1.0, True, "cpu", 0)
    for path in sorted((BENCH / "metrics").glob("*.py")):
        reader = harness.load_module(path, "bm_empty_" + path.stem.replace(".", "_"))
        assert reader.read(run) is None, path.name


def test_a_resnext_configuration_runs_from_new_files_alone(tmp_path):
    """The flagship with the ResNeXt-101 32x8d STN, as a configuration file,
    a limits file and BENCHMARK.json entries in a copy: it resolves, seeds,
    counts, and its predict driver runs correct at tiny sizes."""
    root = tmp_path / "repo"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench_dir = root / "benchmark"
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((bench_dir / "configs" / "flagship.json").read_text())
    cfg["model"]["resnet_name"] = "resnext101_32x8d"
    (bench_dir / "configs" / "flagship-rx101.json").write_text(json.dumps(cfg))
    name = "flagship-rx101.predict.b32"
    (bench_dir / "limits" / f"{name}.json").write_text(
        (bench_dir / "limits" / "flagship.predict.b32.json").read_text())
    bench = harness.load_benchmark(REPO)
    bench["configs"].append({"name": "flagship-rx101", "source": "arXiv:1611.05431",
                             "file": "benchmark/configs/flagship-rx101.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": name, "config": "flagship-rx101",
                               "traffic": "predict.b32", "chips": 1, "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "flagship.predict.b32" in m.get("workloads", []):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.resolve(root, name, root=bench_dir)
    model = cell.config["model"]
    assert 2 * sum(la.macs for la in counts.model_layers(model)
                   if la.kind.startswith("stn")) / 1e9 == pytest.approx(155.2, abs=0.1)
    assert counts.forward_flops(model) / 1e9 == pytest.approx(338.1 + 155.2, abs=0.2)
    assert [m["name"] for m in cell.per_layer] == [
        m["name"] for m in harness.resolve(REPO, "flagship.predict.b32").per_layer]

    cell = cut(cell)
    r = harness.Run(cell, 2 ** 31 + 23, 1.0, False, "cpu", time.perf_counter_ns())
    driver_of(cell).run(r)
    line = harness.result_line(r, "cpu", 1)
    assert line["correct"] and set(line["checks"]) == {"theta_gap", "warp_mismatch"}, line
    # the per-layer readers read the new cell's counts from a trace
    r.trace_summary = {"busy_s": 0.9, "window_s": 1.0, "kernels": 10,
                       "op_seconds": {"conv3x3": 0.5}, "device_by_span": {"model.stn": 0.3}}
    r.peaks = harness.peaks_for("NVIDIA H100 80GB HBM3")
    got = r.per_layer_metrics()
    frames = r.counters["frames_issued"]
    assert got["mfu.predict"]["value"] == pytest.approx(
        100 * counts.forward_flops(r.config["model"]) * frames / r.peaks["fp32_flops"])
    assert got["stn_device_share.predict"]["value"] == pytest.approx(100 * 0.3 / 0.9)
    assert got["conv3x3_roofline.predict"]["value"] > 0
    changed = [p for p, data in before.items() if (root / p).read_bytes() != data]
    assert changed == []
