#!/usr/bin/env python3
"""Which gradients of the data-parallel harness's step change from one run
to the next on one NVIDIA GPU, under cuDNN's default and its deterministic
algorithms.

    python3 scripts/torch_rerun_leaves.py [--size 128 72] [--runs 3]

The step is ``parallel/distributed.py``'s harness (the seeded flagship,
f32, TF32 off, global batch 4, one process): ``--runs`` SGD steps, each
from the same initial state on the same batch, their gradients compared
with the first run's leaf by leaf.  Prints the card's name and power
limit, then for each setting the leaves that differ.  A resumed run can
equal an uninterrupted one bit for bit only where no leaf differs.
"""
import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", nargs=2, type=int, default=(128, 72), metavar=("W", "H"))
    p.add_argument("--runs", type=int, default=3)
    a = p.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    from sports_field_homography_tpu_torch.parallel import distributed as dist_mod

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    size = tuple(a.size)
    h = dist_mod._Harness(size, "cuda:0")
    batch = dist_mod._seeded_batch(4, size, 100, len(h.poi))
    for deterministic in (False, True):
        # the harness sets cuDNN's deterministic algorithms; undo it first
        torch.backends.cudnn.deterministic = deterministic
        runs = []
        for _ in range(a.runs):
            _, grads = h.step(h.fresh("SGD", 1e-3, 0.0), batch, 0, 4, return_grads=True)
            runs.append({n: g.cpu() for n, g in grads.items()})
        differ = sorted({n for r in runs[1:] for n in r if not torch.equal(runs[0][n], r[n])})
        print(f"cudnn.deterministic={deterministic}: {len(differ)} of {len(runs[0])} "
              f"gradient leaves differ over {a.runs} runs at {size[0]}x{size[1]}: {differ}",
              flush=True)


if __name__ == "__main__":
    main()
