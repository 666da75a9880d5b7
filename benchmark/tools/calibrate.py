#!/usr/bin/env python3
"""Readings that a cell's limits are set from: the numbers ``correct``
compares, for the program on many seeds (each a full run of the cell with
a short window) and for the control (the reference in the precision below
the configuration's, in the program's place) on a few, all in one process;
``--witness_seeds`` reads the reference in the configuration's own
precision in the program's place, ``--look`` what the training cell's
worst leaf reads element by element.

    python3 benchmark/tools/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control_seeds 4,5,6 --seconds 2 --out chiprun_out/calibrate.jsonl

Each reading is one JSON line (appended to ``--out``) and printed.  The
limits themselves go into ``limits/<cell>.json`` by hand, between the
largest program reading and the smallest control reading (PERF.md).
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
REPO = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control_seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", default=None, help="plant one of faults.FAULTS under the "
                    "timed path for the program's seeds")
    ap.add_argument("--witness_seeds", default="", help="predict cells: the reference "
                    "in bfloat16 in the program's place")
    ap.add_argument("--look", action="store_true", help="training: what moves the worst "
                    "leaf's change apart, element by element")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.dont_write_bytecode = True
    sys.path[:0] = [str(HERE), str(REPO)]
    from run import cache_dirs

    cache_dirs()
    import harness
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.resolve(REPO, args.workload)
    cell.limits = {}
    driver = harness.load_module(cell.driver_path, "bm_driver_" + cell.driver_path.stem)
    if args.fault:
        import faults

        faults.plant(args.fault, train=cell.traffic["driver"] == "train")
    out = open(args.out, "a") if args.out else None
    kind = torch.cuda.get_device_name(0)

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for side, seeds in (("program", args.seeds), ("control", args.control_seeds),
                        ("witness", args.witness_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            t = time.perf_counter_ns()
            r = harness.Run(cell, seed, args.seconds, False, "cuda", t)
            r.look = args.look
            torch.cuda.reset_peak_memory_stats()
            if side == "program":
                driver.run(r)
                readings = r.readings
            elif side == "control":
                readings = driver.control(r)
            else:
                readings = driver.control(r, quant="bf16")
            emit({"workload": args.workload, "side": side, "fault": args.fault, "seed": seed,
                  "readings": readings, "metrics": r.metrics, "setup_s": r.setup_s, "memory_peak": r.memory_peak,
                  "seconds": (time.perf_counter_ns() - t) * 1e-9, "card": kind})
            del r
            torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
