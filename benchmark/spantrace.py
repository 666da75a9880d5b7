"""Device time by host span: which span issued each kernel and copy of a
traced window.

``torch.profiler``'s CUDA trace pairs each kernel and copy with the CUDA
runtime or driver call that launched it (the host-side event with the same
correlation id).  ``trace_events`` reads both from a stopped profiler;
``host_offset`` ties the launches' clock to the host's
(``perf_counter_ns``) through the clock marker's own launch;
``device_by_span`` gives each kernel's seconds to the span that was the
innermost open one when it was launched.  Spans are matched by time
alone, not by thread: autograd launches the backward from its own thread
while the caller's span stays open.  A kernel with no launch record is
counted apart.

``harness.Run.reduce_trace`` hands it the profiler of a ``--trace 1``
window, with the driver's spans and the program's own
(``sports_field_homography_tpu_torch.utils.trace``, recorded over the
same window).
"""
from __future__ import annotations

import bisect
from collections import defaultdict

from devtrace import _MARKER

__all__ = ["trace_events", "host_offset", "device_by_span", "NO_SPAN"]

NO_SPAN = "no span"


def trace_events(prof):
    """([(start, end, name, correlation)] of the device's kernels, copies
    and sets, {correlation: start of its earliest host event}), on the
    trace's clock."""
    from torch.autograd import DeviceType

    device, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        corr = e.correlation_id()
        s = e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            device.append((s, s + e.duration_ns(), e.name(), corr))
        elif corr and s < launches.get(corr, s + 1):
            launches[corr] = s
    return device, launches


def host_offset(device, launches, t_marker: int):
    """Trace clock minus host clock: the marker kernel's launch on the
    trace against ``t_marker``, read on the host just before it; None
    without the marker's launch record.  The launch call starts a few
    microseconds after ``t_marker``, so mapped host times are early by
    that much."""
    for s, _, name, corr in sorted(device):
        if _MARKER in name:
            t = launches.get(corr)
            return None if t is None else t - t_marker
    return None


def device_by_span(device, launches, offset: int, spans, lo: int, hi: int):
    """Seconds of the device events in the trace window [lo, hi] by the
    span (host clock, ``[(t0, t1, name)]``) that was the latest-started
    one open when each was launched (``NO_SPAN`` outside every span), and
    the seconds of the events with no launch record."""
    out = defaultdict(float)
    unattributed = 0
    timed = []
    for s, e, name, corr in device:
        if _MARKER in name or e <= lo or s >= hi:
            continue
        ns = min(e, hi) - max(s, lo)
        t = launches.get(corr)
        if t is None:
            unattributed += ns
        else:
            timed.append((t - offset, ns))
    timed.sort()
    edges = sorted([(t0, 1, i) for i, (t0, _, _) in enumerate(spans)]
                   + [(t1, 0, i) for i, (_, t1, _) in enumerate(spans) if t1 is not None])
    open_spans = []               # (t0, index), ascending
    k = 0
    for t, ns in timed:
        while k < len(edges) and edges[k][0] <= t:
            at, opens, i = edges[k]
            if opens:
                bisect.insort(open_spans, (at, i))
            else:
                open_spans.remove((spans[i][0], i))
            k += 1
        name = spans[open_spans[-1][1]][2] if open_spans else NO_SPAN
        out[name] += ns * 1e-9
    return dict(out), unattributed * 1e-9
