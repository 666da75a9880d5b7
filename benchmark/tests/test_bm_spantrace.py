"""Device time and idle gaps by the program's own spans (``spantrace``,
``devtrace``), on synthetic trace events and, with a card, on one traced
flagship predict batch."""
import collections
import time

import pytest

import devtrace
import harness
import spantrace
from conftest import BENCH, REPO

MARKER = "void at::spin_kernel(long)"


def _spans(*items):
    return [(t0, t1, name) for name, t0, t1 in items]


def test_a_kernel_goes_to_the_innermost_span_open_at_its_launch():
    spans = _spans(("predict_fn", 0, 1000), ("predict.batch", 10, 900),
                   ("model.unet", 20, 400), ("model.stn", 400, 600), ("to_host", 1000, 1200))
    device = [(5_000, 5_100, "conv3x3_sm90_kernel", 1), (5_100, 5_400, "cudnn", 2),
              (5_400, 5_450, "elementwise", 3), (5_450, 5_500, "Memcpy DtoH", 4),
              (5_500, 5_520, "reduce", 5)]
    launches = {1: 30 + 50, 2: 400 + 50, 3: 650 + 50, 4: 1100 + 50, 5: 5 + 50}
    by, lost = spantrace.device_by_span(device, launches, 50, spans, 0, 10_000)
    assert by == pytest.approx({"model.unet": 100e-9, "model.stn": 300e-9,
                                "predict.batch": 50e-9, "to_host": 50e-9,
                                "predict_fn": 20e-9})
    assert lost == 0


def test_a_backward_kernel_from_another_thread_goes_to_the_open_backward_span():
    """Autograd launches the backward from its own thread: the launch
    records arrive out of the caller's order, matched by time alone."""
    spans = _spans(("train_step", 0, 1000), ("train.step", 0, 1000),
                   ("model.unet", 10, 200), ("train.loss", 200, 300),
                   ("train.backward", 300, 800), ("train.update", 800, 990))
    device = [(2_000 + i * 10, 2_010 + i * 10, f"k{i}", i) for i in range(6)]
    launches = {0: 700, 1: 350, 2: 100, 3: 310, 4: 850, 5: 250}
    by, lost = spantrace.device_by_span(device, launches, 0, spans, 0, 10_000)
    assert by == pytest.approx({"train.backward": 30e-9, "model.unet": 10e-9,
                                "train.update": 10e-9, "train.loss": 10e-9})
    assert lost == 0


def test_kernels_without_a_launch_record_are_counted_apart_and_the_window_clips():
    device = [(0, 100, MARKER, 9), (100, 300, "a", 1), (300, 400, "b", 2),
              (900, 1_100, "c", 3), (1_200, 1_300, "d", 4)]
    launches = {1: 10, 3: 20, 4: 30, 9: 0}
    by, lost = spantrace.device_by_span(device, launches, 0, _spans(("s", 0, 100)), 150, 1_000)
    assert by == pytest.approx({"s": (150 + 100) * 1e-9})
    assert lost == pytest.approx(100e-9)
    assert spantrace.device_by_span(device, launches, 0, [], 150, 1_000)[0] == pytest.approx(
        {spantrace.NO_SPAN: 250e-9})


def test_the_host_offset_comes_from_the_markers_own_launch():
    device = [(9_000, 9_100, "x", 2), (5_400, 5_500, MARKER, 7)]
    assert spantrace.host_offset(device, {7: 5_000, 2: 8_000}, 1_000) == 4_000
    assert spantrace.host_offset(device, {2: 8_000}, 1_000) is None


class _Event:
    def __init__(self, cuda, name, start, dur, corr):
        self._v = (cuda, name, start, dur, corr)

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._v[0] else DeviceType.CPU

    def name(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def test_trace_events_pair_each_kernel_with_its_earliest_host_event():
    events = [_Event(False, "cudaLaunchKernel", 100, 50, 6),
              _Event(False, "Lazy Function Loading", 120, 10, 6),
              _Event(False, "Activity Buffer Request", 90, 10, 0),
              _Event(True, "spin_kernel", 500, 20, 6),
              _Event(False, "cudaMemcpyAsync", 600, 5, 8),
              _Event(True, "Memcpy DtoH (Device -> Pinned)", 610, 30, 8)]
    prof = collections.namedtuple("P", "profiler")(collections.namedtuple("K", "kineto_results")(
        collections.namedtuple("R", "events")(lambda: events)))
    device, launches = spantrace.trace_events(prof)
    assert device == [(500, 520, "spin_kernel", 6), (610, 640, "Memcpy DtoH (Device -> Pinned)", 8)]
    assert launches == {6: 100, 8: 600}


class _FakeTrace(devtrace.DeviceTrace):
    def __init__(self, events):
        super().__init__()
        self.t_marker = 1_000
        self.events = events

    def _device_events(self):
        return self.events


def test_an_idle_gap_inside_a_program_span_is_charged_to_it():
    """The program's spans, added to the driver's, take the gaps they
    enclose from the driver's outer span."""
    off = 5_000_000 - 1_000
    ev = [(5_000_000, 5_000_100, MARKER, ""),
          (off + 0, off + 10_000, "conv3x3_sm90_kernel", ""),
          (off + 30_000, off + 40_000, "cudnn::x", ""),
          (off + 60_000, off + 100_000, "Memcpy DtoH", "")]
    groups = devtrace.load_groups(BENCH / "kernel_groups")
    spans = devtrace.Spans()
    spans.add("predict_fn", 0, 60_000)
    spans.add("to_host", 60_000, 100_000)
    before = _FakeTrace([e[:3] for e in ev]).reduce(0, 100_000, groups, spans)
    assert before["idle_by_span"] == pytest.approx({"predict_fn": 40e-6})
    spans.add("predict.batch", 1_000, 55_000)
    spans.add("model.unet", 2_000, 25_000)
    spans.add("model.stn", 25_000, 45_000)
    after = _FakeTrace([e[:3] for e in ev]).reduce(0, 100_000, groups, spans)
    assert after["idle_by_span"] == pytest.approx({"model.unet": 20e-6, "predict.batch": 20e-6})
    assert {k: v for k, v in after.items() if k != "idle_by_span"} == \
        {k: v for k, v in before.items() if k != "idle_by_span"}


@pytest.mark.cuda
def test_a_traced_flagship_predict_batch_is_all_charged_to_program_spans(cuda_device):
    import torch

    from sports_field_homography_tpu_torch.utils import trace

    cell = harness.resolve(REPO, "flagship.predict.b32")
    r = harness.Run(cell, 2 ** 31 + 5, 1.0, True, cuda_device, 0)
    driver = harness.load_module(cell.driver_path, "bm_test_driver_spantrace")
    fn, pool, _ = driver.setup(r)
    dev = torch.device(cuda_device)
    with torch.inference_mode():
        driver.wait(r, driver.issue(r, fn, pool, 0, 32, dev))
        dt = devtrace.DeviceTrace()
        dt.start()
        trace.start()
        t0 = time.perf_counter_ns()
        driver.wait(r, driver.issue(r, fn, pool, 1, 32, dev))
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
        records = trace.stop()
        dt.stop()
    device, launches = spantrace.trace_events(dt.prof)
    offset = spantrace.host_offset(device, launches, dt.t_marker)
    assert offset is not None
    spans = [(a, b, n) for n, a, b, _, _ in records]
    by, lost = spantrace.device_by_span(device, launches, offset, spans, t0 + offset,
                                        t1 + offset)
    (b0, b1), = [(a, b) for a, b, n in spans if n == "predict.batch"]
    inside = [s for s in device if "spin_kernel" not in s[2]
              and b0 <= launches.get(s[3], -1) - offset < b1]
    assert inside and lost == 0
    assert set(by) <= {"predict.batch", "model.unet", "model.stn", "model.warp",
                       "predict.to_host", spantrace.NO_SPAN}
    program = sum(v for k, v in by.items() if k != spantrace.NO_SPAN)
    assert program >= sum(e - s for s, e, _, _ in inside) * 1e-9 * (1 - 1e-9)
    assert all(by.get(k, 0) > 0 for k in ("model.unet", "model.stn", "model.warp"))
