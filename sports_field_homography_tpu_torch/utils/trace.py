"""Phase spans of the predict and train steps, kept in memory while a
caller records them.

``span(name)`` marks one phase (``predict.batch``, ``model.unet``,
``train.backward``, ...).  Nothing is recorded until a caller calls
``start()``: until then ``span`` returns one shared no-op context, with no
allocation, clock read or lock.  ``stop()`` ends the recording and returns
its records, one a span in the order the spans opened::

    (name, t0_ns, t1_ns, parent, unit)

``t0_ns`` / ``t1_ns`` are ``time.perf_counter_ns()`` at the span's edges
(``t1_ns`` is None for a span still open at ``stop()``); ``parent`` is the
index of the enclosing span on the same thread, None for a root; ``unit``
is the index of the root span, shared by every span of one batch or step.
A body that raises still closes its span.
"""
from __future__ import annotations

import contextlib
import threading
import time

__all__ = ["span", "start", "stop"]

_OFF = contextlib.nullcontext()
_records = None       # the list of start() .. stop(), else None
_lock = threading.Lock()
_local = threading.local()


class _Span:
    __slots__ = ("_records", "_name", "_index", "_stack")

    def __init__(self, records: list, name: str):
        self._records, self._name = records, name

    def __enter__(self):
        records = self._records
        if getattr(_local, "records", None) is not records:
            _local.records, _local.stack = records, []
        stack = self._stack = _local.stack
        parent = stack[-1] if stack else None
        with _lock:
            index = self._index = len(records)
            unit = index if parent is None else records[parent][4]
            records.append([self._name, time.perf_counter_ns(), None, parent, unit])
        stack.append(index)
        return self

    def __exit__(self, *exc):
        self._records[self._index][2] = time.perf_counter_ns()
        self._stack.pop()
        return False


def span(name: str):
    """A context manager around one phase: a no-op unless recording."""
    records = _records
    return _OFF if records is None else _Span(records, name)


def start() -> None:
    """Begin recording into a fresh list (a recording in progress is
    dropped)."""
    global _records
    _records = []


def stop() -> list:
    """End recording; returns its records (empty if none was started)."""
    global _records
    records, _records = _records, None
    if records is None:
        return []
    with _lock:
        return [tuple(r) for r in records]
