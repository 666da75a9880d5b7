"""Device time and idle gaps by the program's own spans (``spantrace``,
``devtrace``, ``harness.Run.reduce_trace``), on synthetic trace events
and, with a card, on one traced flagship predict batch; the program's
spans recorded in a traced run alone."""
import collections
import time

import pytest

import devtrace
import harness
import program
import readers
import spantrace
from conftest import BENCH, REPO, driver_of, tiny_run

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


def _prof(events):
    """A stopped profiler's shape around ``events``."""
    return collections.namedtuple("P", "profiler")(collections.namedtuple("K", "kineto_results")(
        collections.namedtuple("R", "events")(lambda: events)))


def test_trace_events_pair_each_kernel_with_its_earliest_host_event():
    events = [_Event(False, "cudaLaunchKernel", 100, 50, 6),
              _Event(False, "Lazy Function Loading", 120, 10, 6),
              _Event(False, "Activity Buffer Request", 90, 10, 0),
              _Event(True, "spin_kernel", 500, 20, 6),
              _Event(False, "cudaMemcpyAsync", 600, 5, 8),
              _Event(True, "Memcpy DtoH (Device -> Pinned)", 610, 30, 8)]
    device, launches = spantrace.trace_events(_prof(events))
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


class _NoTrace:
    """A device trace that records nothing (the CPU has none)."""

    def start(self):
        pass

    def stop(self):
        pass


@pytest.mark.parametrize("trace", [True, False])
def test_the_programs_spans_are_recorded_in_a_traced_run_alone(trace, monkeypatch):
    from sports_field_homography_tpu_torch.utils import trace as ptrace

    started = []
    real_start = program.start_spans
    monkeypatch.setattr(program, "start_spans", lambda: started.append(1) or real_start())
    monkeypatch.setattr(harness.bmtrace, "DeviceTrace", _NoTrace)
    cell, r = tiny_run("flagship.predict.b32", seconds=0.5)
    r.trace = trace
    r.spans.enabled = trace
    driver_of(cell).run(r)
    assert r.correct
    assert ptrace.span("model.stn") is ptrace.span("model.unet")     # the shared no-op
    if not trace:
        assert started == [] and r.program_spans == [] and r.spans.items == []
        return
    assert started == [1]
    names = {rec[0] for rec in r.program_spans}
    assert {"predict.batch", "model.unet", "model.stn", "model.warp",
            "predict.to_host"} <= names
    t0, t1 = r.t_window
    assert all(t0 <= a <= b <= t1 for _, a, b, _, _ in r.program_spans)


def test_reduce_trace_gives_device_time_and_gaps_to_the_innermost_span():
    """The driver's spans and the program's: each kernel goes to the
    innermost span open at its launch, each idle gap to the one open at its
    middle; ``stn_device_share.predict`` reads ``model.stn`` over busy."""
    off = 4_000_000                  # trace clock - host clock at a launch
    run_at = off + 500               # and at a kernel's start on the card

    def kernel(name, launch, start, end, corr):
        host = [_Event(False, "cudaLaunchKernel", launch + off, 3, corr)] if launch else []
        return host + [_Event(True, name, start + run_at, end - start, corr)]

    events = (kernel("void at::spin_kernel(long)", 1_000, 1_000, 1_200, 1)
              + kernel("conv3x3_sm90_kernel", 13_000, 20_000, 40_000, 2)
              + kernel("cudnn::engine", 31_000, 40_000, 60_000, 3)
              + kernel("elementwise_kernel", 45_000, 60_000, 70_000, 4)
              + kernel("warp_nearest", 52_000, 75_000, 80_000, 5)
              + kernel("Memcpy DtoH (Device -> Pinned)", 62_000, 80_000, 90_000, 6)
              + kernel("unlaunched", None, 90_000, 95_000, 7))
    cell = harness.resolve(REPO, "flagship.predict.b32")
    r = harness.Run(cell, 1, 1.0, True, "cpu", 0)
    r.device_trace = devtrace.DeviceTrace()
    r.device_trace.prof, r.device_trace.t_marker = _prof(events), 1_000
    r.t_window = [10_000, 110_000]
    for name, a, b in (("predict_fn", 10_000, 60_000), ("to_host", 60_000, 80_000),
                       ("wait", 80_000, 110_000)):
        r.spans.add(name, a, b)
    r.program_spans = [("predict.batch", 11_000, 59_000, None, 0),
                       ("model.unet", 12_000, 30_000, 0, 0),
                       ("model.stn", 30_000, 50_000, 0, 0),
                       ("model.warp", 50_000, 58_000, 0, 0),
                       ("predict.to_host", 61_000, 79_000, None, 4)]
    r.reduce_trace()
    ts = r.trace_summary
    assert ts["busy_s"] == pytest.approx(70e-6) and ts["window_s"] == pytest.approx(100e-6)
    assert ts["device_by_span"] == pytest.approx({"model.unet": 20e-6, "model.stn": 30e-6,
                                                  "model.warp": 5e-6,
                                                  "predict.to_host": 10e-6})
    assert ts["device_unattributed_s"] == pytest.approx(5e-6)
    assert ts["idle_by_span"] == pytest.approx({"model.unet": 10e-6,
                                                "predict.to_host": 5e-6, "wait": 15e-6})
    reader = harness.load_module(BENCH / "metrics" / "stn_device_share.predict.py",
                                 "bm_test_stn_device_share")
    assert reader.read(r) == pytest.approx(100 * 30 / 70)
    line = harness.result_line(r, "cpu", 1)
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_span_share_reads_a_span_over_busy_time_and_nothing_where_it_is_absent():
    cell = harness.resolve(REPO, "bilinear-r50.predict.b32")
    r = harness.Run(cell, 1, 1.0, True, "cpu", 0)
    assert readers.span_share(r, "model.stn") is None               # no trace
    r.trace_summary = {"busy_s": 8.0, "window_s": 10.0,
                       "device_by_span": {"model.stn": 2.064, "model.unet": 5.0}}
    assert readers.span_share(r, "model.stn") == pytest.approx(25.8)
    assert readers.span_share(r, "model.unet") == pytest.approx(62.5)
    assert readers.span_share(r, "train.backward") is None         # no such span
    r.trace_summary = {"busy_s": 8.0, "window_s": 10.0}              # spans not recorded
    assert readers.span_share(r, "model.stn") is None


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
