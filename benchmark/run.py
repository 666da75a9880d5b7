#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The run makes
its weights and inputs from ``--seed``, warms up, measures for
``--seconds``, checks what the measured path produced against the plain
reference, and prints as its last line one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics read from a device trace of the
window), ``device``, with ``--trace 1`` a ``breakdown``, and last the
compared numbers beside their limits (``checks``), which also close its
standard error.  Without a CUDA card, or with fewer than the cell asks
for, it exits with 2 and prints no result.  It refuses to print one, with
3, if JAX or the JAX package was imported, or if the run wrote to
``/dev/shm`` or a fixed path under ``/tmp``.
"""
import time

_T_PROCESS_NS = time.perf_counter_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def cache_dirs():
    """Kernel and build caches at fixed paths inside the checkout."""
    build = REPO / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor_cache")
    os.environ["USE_FLAX"] = "0"


def _card():
    """The card's name and power limit from nvidia-smi, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        ap.error("--seed must be >= 0 and --seconds > 0")
    sys.dont_write_bytecode = True
    sys.path[:0] = [str(HERE), str(REPO)]
    cache_dirs()

    import harness

    cell = harness.resolve(REPO, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s), found {found}; "
              "it does not run on the CPU", file=sys.stderr)
        return 2
    watch = harness.WriteWatch()
    kind = torch.cuda.get_device_name(0)
    r = harness.Run(cell, args.seed, args.seconds, bool(args.trace), "cuda", _T_PROCESS_NS)
    r.peaks = harness.peaks_for(kind)
    driver = harness.load_module(cell.driver_path, "bm_driver_" + cell.driver_path.stem)
    try:
        driver.run(r)
        r.reduce_trace()
        line = harness.result_line(r, kind, cell.chips)
    except Exception:
        traceback.print_exc()
        return 1
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: the run imported {bad}: the port must not load JAX or the JAX "
              "package", file=sys.stderr)
        return 3
    writes = watch.new_entries()
    if writes:
        print(f"benchmark: the run wrote outside its checkout, HOME, XDG_CACHE_HOME and "
              f"TMPDIR: {writes}", file=sys.stderr)
        return 3
    checks = line.pop("checks")
    line["card"] = _card()
    line["checks"] = checks
    print(f"{args.workload} seed {args.seed}: correct {line['correct']}, attempted "
          f"{line['attempted']}, failed {line['failed']} [{line['card']}]", file=sys.stderr)
    print(f"counters {json.dumps(r.counters)}", file=sys.stderr)
    print(f"readings {json.dumps(r.readings)}", file=sys.stderr)
    if r.trace_summary is not None:
        print(f"device_by_span {json.dumps(r.trace_summary['device_by_span'])} "
              f"device_unattributed_s {r.trace_summary['device_unattributed_s']!r}",
              file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
