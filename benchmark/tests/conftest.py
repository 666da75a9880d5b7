"""Tests of the benchmark harness on the CPU: the cells at tiny shapes,
driven by calling their drivers directly (the command itself refuses to
run without a card).  Run from the root of the repository:

    python -m pytest benchmark/tests -q
"""
import copy
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent
for p in (str(BENCH), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402

TINY = {"predict.b32": {"pool": 16, "batch": 4, "warmup_batches": 1, "reference_block": 8,
                        "warp_every": 1},
        "train.b26": {"batch": 4}}


def tiny_cell(workload: str):
    """The cell with its model at 64x36 in float32 (the port's CPU path)
    and its traffic cut to a few frames; limits as committed."""
    return cut(harness.Cell(harness.load_benchmark(REPO), REPO, workload))


def cut(cell):
    """``cell`` cut as ``tiny_cell`` cuts: the widths kept, the sizes and
    the traffic made small."""
    cell.config = copy.deepcopy(cell.config)
    model = cell.config["model"]
    model["target_size"] = model["unet_size"] = [64, 36]
    model["dtype"] = "float32"
    for section in ("predict", "train"):
        if section in cell.config:
            size = [128, 72] if section == "predict" else [64, 36]
            cell.config[section]["warp_size"] = cell.config[section]["court_size"] = size
    cell.traffic = dict(cell.traffic, **TINY[cell.spec["traffic"]])
    return cell


def tiny_run(workload: str, seed: int = 2 ** 31 + 11, seconds: float = 1.0):
    cell = tiny_cell(workload)
    return cell, harness.Run(cell, seed, seconds, False, "cpu", time.perf_counter_ns())


def driver_of(cell):
    return harness.load_module(cell.driver_path, "bm_test_driver_" + cell.driver_path.stem)


@pytest.fixture
def cuda_device():
    """Skip (with the reason) where there is no CUDA card; decided when the
    test runs, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


WORKLOADS = [w["name"] for w in harness.load_benchmark(REPO)["workloads"]]
