"""Each cell driven on the CPU at tiny shapes: a sound run is correct, the
control (the reference one precision down in the program's place) is not,
and a run with the timed path broken underneath is not either."""
import math

import pytest
import torch

import faults
import harness
from conftest import REPO, WORKLOADS, driver_of, tiny_run


def _result(workload, seconds=1.0):
    cell, r = tiny_run(workload, seconds=seconds)
    driver_of(cell).run(r)
    return r, harness.result_line(r, "cpu", 1)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_sound_run_is_correct(workload):
    r, line = _result(workload)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    e2e = {m["name"] for m in r.cell.end_to_end}
    assert set(line["metrics"]) == e2e and e2e <= set(r.metrics) | {"setup_s"}
    assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in line["metrics"].values())
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == set(r.cell.limits)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_not_correct(workload):
    cell, r = tiny_run(workload)
    readings = driver_of(cell).control(r)
    over = {k: lim for k, lim in cell.limits.items() if k in readings and readings[k] > lim}
    assert over, (readings, cell.limits)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_not_correct_on_the_card(workload, cuda_device):
    cell = harness.resolve(REPO, workload)
    driver = driver_of(cell)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        r = harness.Run(cell, seed, 1.0, False, cuda_device, 0)
        readings = driver.control(r)
        assert any(k in readings and readings[k] > lim for k, lim in cell.limits.items()), \
            readings


FAULTS = [(w, f) for w in WORKLOADS
          for f in (("unchanged", "half_batch", "altered") if ".train." in w
                    else ("half_batch", "altered", "warp_shift"))]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(workload, fault):
    restore = faults.plant(fault, train=".train." in workload)
    try:
        cell, r = tiny_run(workload)
        driver_of(cell).run(r)
    finally:
        restore()
    line = harness.result_line(r, "cpu", 1)
    assert not line["correct"], line["checks"]


def test_the_same_seed_gives_the_same_inputs():
    """The same seed gives the same inputs: two runs of a cell compare the
    same frames with the same weights."""
    import inputs

    a = inputs.seeded_state_dict({"mask_classes": 4, "unet_bilinear": False,
                                  "resnet_name": "resnet18"}, 2 ** 33 + 1, "cpu")
    b = inputs.seeded_state_dict({"mask_classes": 4, "unet_bilinear": False,
                                  "resnet_name": "resnet18"}, 2 ** 33 + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    labels, poi = inputs.court((64, 36))
    f1 = inputs.render(4, (64, 36), labels, poi, 5, "cpu")
    f2 = inputs.render(4, (64, 36), labels, poi, 5, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(f1, f2))
    assert not torch.equal(f1[0], inputs.render(4, (64, 36), labels, poi, 6, "cpu")[0])

