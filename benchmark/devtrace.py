"""Host spans and the device trace of the measured window.

``Spans`` holds the spans the drivers record around their calls into the
program (host clock, ``perf_counter_ns``).  ``DeviceTrace`` runs
``torch.profiler`` with CUDA activity only over the window and reduces its
events in memory (nothing is written to disk): the time some operation ran
on the card (the union of kernel, copy and set intervals), the time per
kernel group (``kernel_groups/*.json``, first match by ``order``), the
number of kernels, and each idle gap on the card charged to the host span
that was open at its middle.  A spin kernel launched right after a
synchronisation at a known host time ties the trace's clock to the host's;
``window_ns`` is the window on the trace's clock.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import threading
import time
from collections import defaultdict
from pathlib import Path

__all__ = ["Spans", "DeviceTrace", "load_groups", "classify"]

_COPY_PREFIXES = ("Memcpy", "Memset")
_MARKER = "spin_kernel"


class Spans:
    """Named host intervals; ``span(name)`` from any thread.  Only a traced
    run records them (``enabled``)."""

    def __init__(self, enabled: bool = True):
        self.items = []
        self.enabled = enabled
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.add(name, t0, time.perf_counter_ns())

    def add(self, name: str, t0: int, t1: int) -> None:
        with self._lock:
            self.items.append((t0, t1, name))


def load_groups(directory: Path):
    """[(name, order, patterns lower-cased, op or None)] in match order."""
    groups = []
    for path in sorted(Path(directory).glob("*.json")):
        spec = json.loads(path.read_text())
        groups.append((path.stem, float(spec["order"]),
                       [p.lower() for p in spec["patterns"]], spec.get("op")))
    return sorted(groups, key=lambda g: (g[1], g[0]))


def classify(name: str, groups) -> str:
    low = name.lower()
    for gname, _, patterns, _ in groups:
        if any(p in low for p in patterns):
            return gname
    return "other"


class DeviceTrace:
    """``start()`` before the window, ``stop()`` after its work has
    drained; ``reduce(...)`` then gives the window's device numbers."""

    def __init__(self):
        self.prof = None
        self.t_marker = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.t_marker = time.perf_counter_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self.prof.stop()

    def _device_events(self):
        from torch.autograd import DeviceType

        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                s = e.start_ns()
                out.append((s, s + e.duration_ns(), e.name()))
        return out

    def reduce(self, t0_ns: int, t1_ns: int, groups, spans: Spans):
        """Device numbers of the host window [t0_ns, t1_ns] (perf_counter)."""
        events = self._device_events()
        markers = [e for e in events if _MARKER in e[2]]
        if not markers:
            raise RuntimeError("device trace: the clock marker kernel is missing; "
                               f"{len(events)} device events")
        offset = min(markers)[0] - self.t_marker
        lo, hi = t0_ns + offset, t1_ns + offset
        by_group = defaultdict(float)
        op_seconds = defaultdict(float)
        ops = {g[0]: g[3] for g in groups}
        cache = {}
        intervals = []
        kernels = 0
        for s, e, name in events:
            if _MARKER in name or e <= lo or s >= hi:
                continue
            s, e = max(s, lo), min(e, hi)
            intervals.append((s, e))
            g = cache.get(name)
            if g is None:
                g = cache[name] = classify(name, groups)
            by_group[g] += (e - s) * 1e-9
            if ops.get(g):
                op_seconds[ops[g]] += (e - s) * 1e-9
            if not name.startswith(_COPY_PREFIXES):
                kernels += 1
        intervals.sort()
        busy, gaps, cur_s, cur_e = 0, [], None, lo
        for s, e in intervals:
            if cur_s is None or s > cur_e:
                if cur_s is not None:
                    busy += cur_e - cur_s
                if s > cur_e:
                    gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_s is not None:
            busy += cur_e - cur_s
        if hi > cur_e:
            gaps.append((cur_e, hi))
        return {"busy_s": busy * 1e-9, "window_s": (hi - lo) * 1e-9, "window_ns": (lo, hi),
                "kernels": kernels, "groups": dict(by_group), "op_seconds": dict(op_seconds),
                "idle_by_span": _charge_gaps(gaps, offset, spans)}


def _charge_gaps(gaps, offset, spans: Spans):
    """Seconds of idle device time by the host span open at each gap's
    middle (the latest-started one where spans overlap)."""
    items = sorted(spans.items)
    starts = [s for s, _, _ in items]
    out = defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2 - offset
        i = bisect.bisect_right(starts, mid) - 1
        name = "no span"
        for j in range(i, max(i - 256, -1), -1):
            s, e, n = items[j]
            if s <= mid < e:
                name = n
                break
        out[name] += (g1 - g0) * 1e-9
    return dict(out)
