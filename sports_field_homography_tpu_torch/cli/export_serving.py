"""Export a checkpoint to a self-contained serving artifact (port of
``scripts/export_serving.py``).

Builds the program the predict CLI runs (the same ``--req_outputs``
pruning, uint8 frames divided by 255 in the program, folded BN, K1 on the
sampled or full grid) and saves it with ``torch.export``, weights and court
constants inside (``compat/serving.py``)::

    python -m sports_field_homography_tpu_torch.cli.export_serving \\
        --load ckpt/CP_epoch30.pth --req_outputs theta,consistency \\
        --batchsize 32 [--dst ckpt/serving] [--device cpu]

``--buckets 1,2,4,8,16,32`` loads the checkpoint once and writes one
fixed-batch artifact a size under ``<dst>/b{N}``, the directory that
``serve.server --serving_artifact`` serves bucket by bucket;
``--poly_batch`` writes one artifact with a symbolic batch instead.  The
weights are a reference-keyed ``.pth`` or the JAX package's ``.msgpack``,
with the ``conf.yaml`` beside them (the JAX script's overlay rules).  The
artifact runs on the device it is exported on (``--device``, default
cuda): export a CUDA artifact on the card that serves it.  ``--platforms``
is accepted for the JAX command lines, as ``cuda`` or ``cpu`` only, and
must name that device.
"""
from __future__ import annotations

import argparse
import os
import time

from ..compat.serving import export_predict, save_serving
from ..utils.config import get_prediction_args, parse_config, replace_args
from .engine import build_model, check_loadable, discover_conf

__all__ = ["main", "build_bundle"]

# the JAX script's conf overlay list, plus the port's device (a run-time choice)
_CONF_IGNORE = ["conf_path", "batchsize", "court_img", "court_poi", "img_dir",
                "court_size", "warp_size", "load", "compute_dtype", "num_devices",
                "device"]


def _own_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--platforms", default=None,
                    help="cuda or cpu: the device the artifact runs on, which must be "
                         "--device's (the JAX script's lowering targets)")
    ap.add_argument("--dst", default=None,
                    help="artifact directory (default: <load>_serving)")
    ap.add_argument("--poly_batch", action="store_true", default=False,
                    help="export with a symbolic batch dimension: one artifact serves "
                         "any batch size (--batchsize becomes the recommended size)")
    ap.add_argument("--buckets", default=None,
                    help="comma list of batch sizes, e.g. 1,8,32: one fixed-batch "
                         "artifact a size under <dst>/b{N}, which serve.server "
                         "--serving_artifact serves as its buckets")
    return ap


def build_bundle(args):
    """The predict CLI's model from parsed prediction args: the conf
    overlay, the size rules, the kept outputs.  Returns ``(bundle,
    consistency, project_poi, keep)``."""
    args.conf_path = discover_conf(args.load, args.conf_path)
    if args.conf_path is not None:
        print(f"Reading params from {args.conf_path}...")
        args = replace_args(args, parse_config(args.conf_path), ignore_keys=_CONF_IGNORE)
    check_loadable(args.load)
    args.out_size = tuple(args.out_size)
    if args.court_size[0] < args.out_size[0]:
        args.court_size = args.out_size
    if args.warp_size[0] < args.out_size[0]:
        args.warp_size = args.out_size

    req_outputs = set(args.req_outputs.split(","))
    project_poi = "poi" in req_outputs
    consistency = "consistency" in req_outputs
    if "debug" in req_outputs:
        req_outputs.add("warp_mask")
    args.use_warper = "warp_mask" in req_outputs or consistency
    if consistency and not args.use_unet:
        raise ValueError("consistency needs the UNet")
    if project_poi and not args.use_warper:
        raise ValueError("poi needs the warper: ask for warp_mask or consistency too")
    keep = sorted({"segm_mask", "warp_mask", "theta", "poi"} & req_outputs
                  | ({"consist_score"} if consistency else set()))
    bundle = build_model(args, load=args.load, warp_with_nearest=True,
                         fold_bn=bool(args.fold_bn))
    return bundle, consistency, project_poi, keep


def _default_dst(load) -> str:
    base = load or "model"
    for suffix in (".msgpack", ".pth"):
        if base.endswith(suffix):
            base = base[: -len(suffix)]
    return base + "_serving"


def main(argv=None):
    """Export; returns one record a written artifact: ``{"dir", "batch",
    "seconds", "mb"}`` (``batch`` None for a poly_batch artifact)."""
    ap = _own_parser()
    own, rest = ap.parse_known_args(argv)
    if own.buckets and own.poly_batch:
        ap.error("--buckets and --poly_batch are mutually exclusive")
    args = get_prediction_args(rest)
    device_type = args.device.split(":")[0]
    if own.platforms is not None:
        platforms = own.platforms.split(",")
        if any(p not in ("cuda", "cpu") for p in platforms):
            ap.error(f"--platforms {own.platforms}: this port exports for cuda or cpu only")
        if platforms != [device_type]:
            ap.error(f"--platforms {own.platforms}: an artifact runs on the device it is "
                     f"exported on, here --device {args.device}")
    batches = [None]
    if own.buckets:
        batches = sorted({int(b) for b in own.buckets.split(",")})
        if batches[0] < 1:
            ap.error("--buckets entries must be >= 1")

    bundle, consistency, project_poi, keep = build_bundle(args)
    dst = own.dst or _default_dst(args.load)
    records = []
    for b in batches:
        sub = dst if b is None else os.path.join(dst, f"b{b}")
        t0 = time.perf_counter()
        ep, meta = export_predict(bundle, consistency=consistency, project_poi=project_poi,
                                  keep=keep, batch_size=args.batchsize if b is None else b,
                                  poly_batch=own.poly_batch)
        save_serving(sub, ep, meta)
        secs = time.perf_counter() - t0
        mb = os.path.getsize(os.path.join(sub, "program.pt2")) / 1e6
        records.append({"dir": sub, "batch": None if own.poly_batch else meta["input"]["shape"][0],
                        "seconds": secs, "mb": mb})
        print(f"exported serving artifact -> {sub} (batch {meta['input']['shape'][0]}, "
              f"{len(meta['outputs'])} outputs, {mb:.1f} MB, {meta['weights_dtype']} weights, "
              f"platforms={meta['platforms']}, {secs:.1f} s)", flush=True)
    return records


if __name__ == "__main__":
    main()
