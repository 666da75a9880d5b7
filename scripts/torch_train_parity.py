#!/usr/bin/env python3
"""Where the f32 train step of the PyTorch port
(``sports_field_homography_tpu_torch``) differs between runs, and why.

    python3 scripts/torch_train_parity.py [--cases 64x36x3,128x72x3]
        [--seeds 5,6] [--out parity.jsonl]

For each case (W x H x batch) and seed, one train step of the flagship
(``chip_smoke.parity_step``: seeded weights, synthetic court renders, the
example conf's losses with the consistency loss on) runs as

  cuda    f32 on the GPU (TF32 off, deterministic cuDNN), when there is one;
  cpu     f32 on the CPU (the kernels' plain versions);
  cpu64   float64 on the CPU, from the same weights and batch;
  cpu_p   f32 on the CPU with every weight moved by one ulp (2**-23
          relative): the step's own noise floor;

and once more with the consistency labels of ``cpu`` given to ``cuda`` and
``cpu64`` (``*_shared``).  The consistency labels are
``trunc(warp * classes)``; inside a class region the bilinear warp sits
within an ulp of the class value, so a label follows the warp's last bit.
Prints, for each pair of runs, how many labels differ, the worst and the
median gradient rel-L2 (the slice's leaves, ``chip_smoke.grad_gaps``) and
the worst relative loss difference; ``--out`` also writes them as JSON
lines.  With ``--modules`` (GPU only) it also prints
``chip_smoke.module_parity``: each UNet module replayed from its inputs
and output cotangent in the step, CUDA vs CPU vs float64, with the count
of ReLU mask bits that differ (CUDA/CPU, CUDA/float64, CPU/float64).
"""
import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PAIRS = [("cuda", "cpu"), ("cuda", "cpu64"), ("cpu", "cpu64"), ("cpu_p", "cpu"),
         ("cuda_shared", "cpu"), ("cuda_shared", "cpu64_shared"),
         ("cpu", "cpu64_shared")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default="64x36x3,128x72x3")
    ap.add_argument("--seeds", default="5,6")
    ap.add_argument("--out", default=None, help="also write JSON lines here")
    ap.add_argument("--modules", action="store_true",
                    help="also replay each UNet module (needs a GPU)")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    has_cuda = torch.cuda.is_available()
    if has_cuda:
        chip_smoke.phase_device()
        chip_smoke.phase_build()
    out = open(args.out, "w") if args.out else None
    for case in args.cases.split(","):
        w, h, b = (int(v) for v in case.split("x"))
        for seed in (int(s) for s in args.seeds.split(",")):
            def step(device, **kw):
                return chip_smoke.parity_step(device, (w, h), b, seed, **kw)

            runs = {"cpu": step("cpu")}
            shared = runs["cpu"][2]
            runs["cpu64"] = step("cpu", dtype=torch.float64)
            runs["cpu64_shared"] = step("cpu", dtype=torch.float64, consist_labels=shared)
            runs["cpu_p"] = step("cpu", perturb=2.0 ** -23)
            if has_cuda:
                runs["cuda"] = step("cuda")
                runs["cuda_shared"] = step("cuda", consist_labels=shared)
            for a, r in PAIRS:
                if a not in runs or r not in runs:
                    continue
                (la, ga, lab_a), (lr, gr, lab_r) = runs[a], runs[r]
                worst, name, median, n = chip_smoke.grad_gaps(ga, gr)
                loss = max(abs(la[k] - lr[k]) / max(abs(lr[k]), 1e-30) for k in lr)
                flips = int((lab_a != lab_r).sum())
                rec = {"case": case, "seed": seed, "pair": f"{a} vs {r}",
                       "label_flips": flips, "labels": lab_a.numel(),
                       "worst_grad": worst, "worst_leaf": name,
                       "median_grad": median, "leaves": n, "worst_loss": loss}
                print(f"{case} seed {seed} {a:>11} vs {r:<12}: labels differ "
                      f"{flips:5d}/{lab_a.numel()}; grad rel-L2 worst {worst:.3e} "
                      f"({name}), median {median:.3e} over {n}; loss {loss:.2e}",
                      flush=True)
                if out:
                    out.write(json.dumps(rec) + "\n")
            if args.modules and has_cuda:
                for name, (flips, got) in chip_smoke.module_parity((w, h), b, seed).items():
                    cc, c64, p64 = (max((e[i], t) for t, e in got.items()) for i in range(3))
                    print(f"{case} seed {seed} module {name:6s}: ReLU mask bits differing "
                          f"{flips[0]}/{flips[1]}/{flips[2]}; worst rel-L2 CUDA vs CPU "
                          f"{cc[0]:.2e} ({cc[1]}), CUDA vs float64 {c64[0]:.2e} ({c64[1]}), "
                          f"CPU vs float64 {p64[0]:.2e} ({p64[1]})", flush=True)
                    if out:
                        out.write(json.dumps({"case": case, "seed": seed, "module": name,
                                              "mask_flips": flips, "rel_l2": got}) + "\n")
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
