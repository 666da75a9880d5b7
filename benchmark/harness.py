"""The benchmark's harness: finds a cell's configuration, traffic, driver,
limits, per-layer metrics and kernel groups by the names in
``BENCHMARK.json``, runs the driver, and prints the result.

Everything that belongs to one configuration, traffic mix, metric or
kernel group is a file of its own, found by name:

    configs/<config>.json       sizes, dtype and settings, with the source
    traffic/<traffic>.json      the mix's parameters and its ``driver``
    drivers/<driver>.py         ``run(r)``: set-up, window, check
    limits/<workload>.json      the limit of each number ``correct`` compares
    metrics/<metric>.py         ``read(r)``: one per-layer metric, or None
    kernel_groups/<group>.json  kernel-name patterns of one group

A driver calls ``r.begin_window()`` when set-up ends, ``r.end_window()``
once the window's work has drained, ``r.record_memory()`` before it frees
the program, and ``r.compare(readings)`` with the numbers it read against
the reference: those that the cell's limits file names are compared.

With ``--trace 1`` the window is traced on the device and the program
records its own phase spans (``program.start_spans``); each kernel's
device time goes to the innermost span open at its launch
(``spantrace``), and each idle gap to the innermost span open at its
middle.  With ``--trace 0`` neither is recorded.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import devtrace as bmtrace
import program
import spantrace

__all__ = ["ROOT", "FORBIDDEN", "forbidden_modules", "load_benchmark", "Cell", "resolve",
           "load_module", "Run", "result_line", "peaks_for", "WriteWatch"]

ROOT = Path(__file__).resolve().parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "sports_field_homography_tpu"})


def forbidden_modules(modules=None):
    """The loaded modules whose whole top-level name is JAX's or the JAX
    package's (``sports_field_homography_tpu_torch`` is neither)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)


def load_benchmark(repo: Path) -> dict:
    with open(Path(repo) / "BENCHMARK.json") as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, bench: dict, repo: Path, workload: str, root: Path = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
        self.name = workload
        self.spec = cells[workload]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.spec["config"]]
        with open(Path(repo) / self.config_entry["file"]) as f:
            self.config = json.load(f)
        with open(root / "traffic" / f"{self.spec['traffic']}.json") as f:
            self.traffic = json.load(f)
        self.driver_path = root / "drivers" / f"{self.traffic['driver']}.py"
        if not self.driver_path.is_file():
            raise FileNotFoundError(self.driver_path)
        limits = root / "limits" / f"{workload}.json"
        self.limits = json.loads(limits.read_text())["limits"] if limits.is_file() else {}
        self.end_to_end = [m for m in bench["end_to_end"]
                           if "workloads" not in m or workload in m["workloads"]]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (workload in m["workloads"] if "workloads" in m
                              else m["moves"] in e2e)]
        self.metric_paths = {m["name"]: root / "metrics" / f"{m['name']}.py"
                             for m in self.per_layer}
        self.groups = bmtrace.load_groups(root / "kernel_groups")
        self.chips = int(self.spec["chips"])


def resolve(repo: Path, workload: str, root: Path = ROOT) -> Cell:
    return Cell(load_benchmark(repo), repo, workload, root)


def peaks_for(kind: str, root: Path = ROOT):
    """The peak rates of the card named ``kind``, or None."""
    with open(root / "peaks.json") as f:
        for card in json.load(f)["cards"]:
            if card["match"] in kind:
                return card
    return None


class WriteWatch:
    """Entries that appear during the run in the shared directories a run
    must not write to (``/dev/shm``, and ``/tmp`` unless it is ``TMPDIR``,
    ``HOME`` or ``XDG_CACHE_HOME``), owned by this user."""

    def __init__(self):
        allowed = {os.path.realpath(os.environ[k]) for k in ("TMPDIR", "HOME", "XDG_CACHE_HOME")
                   if os.environ.get(k)}
        self.dirs = [d for d in ("/dev/shm", "/tmp")
                     if os.path.isdir(d) and os.path.realpath(d) not in allowed]
        self.before = {d: self._list(d) for d in self.dirs}

    @staticmethod
    def _list(d):
        try:
            return set(os.listdir(d))
        except OSError:
            return set()

    def new_entries(self):
        out = []
        for d in self.dirs:
            for name in sorted(self._list(d) - self.before[d]):
                path = os.path.join(d, name)
                try:
                    if os.lstat(path).st_uid == os.getuid():
                        out.append(path)
                except OSError:
                    pass
        return out


class Run:
    """One run of one cell: what the driver reads and what it reports."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device: str,
                 t_process_ns: int):
        self.cell = cell
        self.workload = cell.name
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.look = False           # drivers keep what a calibration's look reads
        self.device = device
        self.t_process_ns = t_process_ns
        self.spans = bmtrace.Spans(enabled=self.trace)
        self.program_spans = []
        self.counters = {}
        self.metrics = {}
        self.checks = {}
        self.readings = {}
        self.attempted = 0
        self.failed = 0
        self.memory_peak = 0
        self.setup_s = None
        self.t_window = None
        self.device_trace = None
        self.trace_summary = None
        self.peaks = None

    # -- called by the driver
    def begin_window(self) -> int:
        """End of set-up: starts the device trace and the program's spans
        (``--trace 1``) and returns the window's start on the host clock
        (perf_counter_ns)."""
        if self.trace:
            self.device_trace = bmtrace.DeviceTrace()
            self.device_trace.start()
            program.start_spans()
        t0 = time.perf_counter_ns()
        self.setup_s = (t0 - self.t_process_ns) * 1e-9
        self.t_window = [t0, None]
        return t0

    def end_window(self) -> int:
        """Call once the window's work has drained on the device."""
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
        self.t_window[1] = t1
        if self.device_trace is not None:
            self.device_trace.stop()
            self.program_spans = program.stop_spans()
        return t1

    def record_memory(self):
        if self.device != "cpu":
            import torch

            self.memory_peak = int(torch.cuda.max_memory_allocated())

    def compare(self, readings: dict):
        """Hold the numbers that ``limits/<workload>.json`` names to their
        limits; every reading is kept in ``self.readings``."""
        self.readings = dict(readings)
        unknown = sorted(set(self.cell.limits) - set(readings))
        if unknown:
            raise KeyError(f"limits/{self.workload}.json: no reading for {unknown} "
                           f"(readings: {sorted(readings)})")
        for name, limit in self.cell.limits.items():
            self.checks[name] = (float(readings[name]), float(limit))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for v, lim in self.checks.values())

    # -- after the driver
    def reduce_trace(self):
        """The window's device numbers (``DeviceTrace.reduce``), with the
        program's spans among the driver's, and ``device_by_span``: the
        device seconds by the innermost span open at each launch, and
        ``device_unattributed_s``: those with no launch record."""
        if self.device_trace is None:
            return
        dt, self.device_trace = self.device_trace, None
        for name, a, b, _, _ in self.program_spans:
            if b is not None:
                self.spans.add(name, a, b)
        t0, t1 = self.t_window
        ts = dt.reduce(t0, t1, self.cell.groups, self.spans)
        device, launches = spantrace.trace_events(dt.prof)
        offset = spantrace.host_offset(device, launches, dt.t_marker)
        if offset is None:
            raise RuntimeError("device trace: the clock marker's launch record is missing")
        lo, hi = ts["window_ns"]
        ts["device_by_span"], ts["device_unattributed_s"] = spantrace.device_by_span(
            device, launches, offset, self.spans.items, lo, hi)
        self.trace_summary = ts

    def per_layer_metrics(self):
        out = {}
        for m in self.cell.per_layer:
            path = self.cell.metric_paths[m["name"]]
            reader = load_module(path, "bm_metric_" + path.stem.replace(".", "_").replace("-", "_"))
            value = reader.read(self)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out


def result_line(r: Run, kind: str, count: int):
    """The contract's last line as a dict."""
    if r.trace:
        metrics = r.per_layer_metrics()
    else:
        names = [m["name"] for m in r.cell.end_to_end]
        missing = [n for n in names if n != "setup_s" and n not in r.metrics]
        if missing:
            raise RuntimeError(f"the driver reported no {missing}")
        metrics = {m["name"]: {"value": float(r.setup_s if m["name"] == "setup_s"
                                              else r.metrics[m["name"]]), "unit": m["unit"]}
                   for m in r.cell.end_to_end}
    device = {"platform": "gpu" if r.device != "cpu" else "cpu", "kind": kind, "count": count,
              "memory_peak_bytes": r.memory_peak}
    out = {"correct": r.correct, "attempted": int(r.attempted), "failed": int(r.failed),
           "metrics": metrics, "device": device}
    if r.trace_summary is not None:
        ts = r.trace_summary
        device["busy_s"] = ts["busy_s"]
        device["window_s"] = ts["window_s"]
        top = sorted(ts["groups"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(ts["idle_by_span"].items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[k, v] for k, v in top],
                            "idle_gaps": [[k, v] for k, v in gaps]}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in r.checks.items()}
    return out
