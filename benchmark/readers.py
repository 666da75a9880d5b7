"""What the per-layer metric files (``metrics/<name>.py``) read: shares of
the traced window, FLOPs and bytes from ``counts`` over the peaks of
``peaks.json``.  Each returns None where the run has nothing to read (no
trace, no peak for the card, no unit of work), never 0 for a share of a
peak or a roofline.
"""
from __future__ import annotations

import counts

__all__ = ["idle_share", "mfu", "op_roofline", "span_share", "launches_per_unit"]

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
_PEAK_KEY = {"bfloat16": "bf16_flops", "float16": "fp16_flops", "float32": "fp32_flops"}


def _trace(r):
    ts = r.trace_summary
    return ts if ts and ts["window_s"] > 0 else None


def idle_share(r):
    """Percent of the traced window in which nothing ran on the card."""
    ts = _trace(r)
    return None if ts is None else 100.0 * (1.0 - ts["busy_s"] / ts["window_s"])


def _peak(r):
    dtype = r.config["model"]["dtype"]
    return None if r.peaks is None else r.peaks.get(_PEAK_KEY[dtype])


def mfu(r, passes: int):
    """Percent of the card's peak FLOP rate: ``passes`` times the model's
    forward FLOPs for every frame issued in the window, over the traced
    window."""
    ts, peak = _trace(r), _peak(r)
    frames = r.counters.get("frames_issued", 0)
    if ts is None or peak is None or frames <= 0:
        return None
    flops = passes * counts.forward_flops(r.config["model"]) * frames
    return 100.0 * flops / (peak * ts["window_s"])


def op_roofline(r, op: str, work):
    """Percent of one operation's roofline: the least time for the work
    of every unit issued (``work(model_cfg, batch, act_bytes)`` -> FLOPs,
    bytes, per unit), over the time of the kernels whose group file names
    ``op``."""
    ts, peak = _trace(r), _peak(r)
    units = r.counters.get("units_issued", 0)
    seconds = (ts or {}).get("op_seconds", {}).get(op, 0.0)
    if ts is None or peak is None or units <= 0 or seconds <= 0:
        return None
    model = r.config["model"]
    flops, nbytes = work(model, r.counters["batch"], _DTYPE_BYTES[model["dtype"]])
    least = units * counts.bound_seconds(flops, nbytes, peak, r.peaks["hbm_bytes_per_s"])
    return 100.0 * least / seconds


def span_share(r, name: str):
    """Percent of the card's busy time in the kernels and copies launched
    while the span ``name`` was the innermost one open (the program's
    spans, recorded with ``--trace 1``)."""
    ts = _trace(r)
    seconds = (ts or {}).get("device_by_span", {}).get(name, 0.0)
    if ts is None or ts["busy_s"] <= 0 or seconds <= 0:
        return None
    return 100.0 * seconds / ts["busy_s"]


def launches_per_unit(r, key: str):
    """Kernels in the traced window per frame or step issued."""
    ts, n = _trace(r), r.counters.get(key, 0)
    return None if ts is None or n <= 0 else ts["kernels"] / n
