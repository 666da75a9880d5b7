"""Batch-inference CLI: image directory -> ``{game}_court.json``.

Port of ``cli/predict.py`` for the predict slice: frames from an image
directory, theta and the consistency score per frame.  The output file
has the JAX CLI's format: one entry per frame,
``{name: {"score": <5-decimal float>, "theta": [[[3x3]]]}}``, plus
``"model"``.  Run it with::

    python -m sports_field_homography_tpu_torch.cli.predict \\
        --img_dir frames/ --load ckpt/model.pth --dst_dir out/ \\
        --req_outputs theta,consistency

Pipeline: a threaded decode loader, pinned non-blocking copies to the
device two batches ahead, the model on the current stream, and the small
results copied back without blocking and written one batch later, so the
host never waits on the batch it just launched.
"""
from __future__ import annotations

import json
import os
import time

import torch

from ..data.dataset import BasicDataset
from ..data.loader import Loader, device_prefetch
from ..utils.config import get_prediction_args, parse_config, replace_args
from ..utils.logger import get_logger
from .engine import build_model, discover_conf

__all__ = ["process", "main"]

_PORTED_OUTPUTS = {"theta", "consistency"}
_CONF_IGNORE = ["conf_path", "batchsize", "court_img", "court_poi", "img_dir",
                "court_size", "warp_size", "load", "compute_dtype",
                "num_devices", "resume"]


def _check_slice(args, req_outputs) -> None:
    """Raise on what this port does not do yet, naming its ROADMAP step."""
    todo = sorted(set(req_outputs) - _PORTED_OUTPUTS)
    if todo:
        raise NotImplementedError(
            f"--req_outputs {','.join(todo)}: only theta and consistency are "
            "ported; segm/warp masks, poi and debug renders are ROADMAP.md "
            "queue 1 step 4")
    if args.video_path:
        raise NotImplementedError(
            "--video_path: the video source is ROADMAP.md queue 1 step 4")
    if args.resume:
        raise NotImplementedError("--resume is ROADMAP.md queue 1 step 4")
    if args.num_devices not in (None, 1) or args.num_hosts is not None \
            or args.coordinator is not None:
        raise NotImplementedError(
            "--num_devices/--num_hosts: multi-device predict is ROADMAP.md "
            "queue 1 step 7")
    if args.img_dir is None:
        raise ValueError("--img_dir is required")


def _to_host(preds, keys, device):
    """Start copying ``keys`` of ``preds`` to the host; returns (tensors,
    event or None).  On CUDA the copies go to pinned memory and an event
    marks their completion."""
    if device.type != "cuda":
        return {k: preds[k].clone() for k in keys}, None
    host = {}
    for k in keys:
        v = preds[k]
        host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host[k].copy_(v, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def process(argv=None, num_data_workers: int = 4) -> dict:
    """Run the CLI; returns ``{"frames": n, "seconds": t}`` for the loop."""
    args = get_prediction_args(argv)
    args.conf_path = discover_conf(args.load, args.conf_path)
    if args.conf_path is not None:
        print("Reading params from {}...".format(args.conf_path))
        args = replace_args(args, parse_config(args.conf_path),
                            ignore_keys=_CONF_IGNORE)
    args.out_size = tuple(args.out_size)
    if args.court_size[0] < args.out_size[0]:
        args.court_size = args.out_size
    if args.warp_size[0] < args.out_size[0]:
        args.warp_size = args.out_size

    req_outputs = [n for n in args.req_outputs.split(",") if n]
    _check_slice(args, req_outputs)
    consistency = "consistency" in req_outputs
    keep = (["theta"] if "theta" in req_outputs else []) + \
        (["consist_score"] if consistency else [])
    args.use_warper = consistency
    if consistency and not args.use_unet:
        raise ValueError("consistency needs the UNet")
    os.makedirs(args.dst_dir, exist_ok=True)
    game_name = os.path.basename(args.img_dir)
    logger = get_logger(format="%(message)s", write_date=False)

    bundle = build_model(args, load=args.load, fold_bn=bool(args.fold_bn))
    model, device = bundle.model, bundle.device
    ids = sorted(n for n in os.listdir(args.img_dir)
                 if os.path.isfile(os.path.join(args.img_dir, n)))
    data = BasicDataset(ids, args.img_dir, target_size=args.target_size)
    loader = Loader(data, args.batchsize, num_workers=num_data_workers)
    logger.info(f"""Start making predictions:
            Model file:        {args.load}
            Device:            {device}
            Compute dtype:     {args.compute_dtype}
            Images dir:        {args.img_dir}
            Num images:        {len(data)}
            Batch size:        {args.batchsize}
            Dest dir:          {args.dst_dir}
            Required outputs:  {req_outputs}
            ResNet input size: {args.target_size}
            UNET input size:   {args.unet_size}
            Court img size:    {args.court_size}
            Warping size:      {args.warp_size}
        """)

    records = {}

    def write(pending):
        host, event, names, nv = pending
        if event is not None:
            event.synchronize()
        for i, n in enumerate(names[:nv]):
            t = n.split("/")
            rec = {}
            if "consist_score" in host:
                rec["score"] = float("{:5f}".format(float(host["consist_score"][i])))
            if "theta" in host:
                rec["theta"] = host["theta"][i].tolist()
            records[t[1] if len(t) == 2 else t[0]] = rec

    try:
        from tqdm import tqdm
        pbar = tqdm(total=len(data), desc="Processing", unit="img")
    except ImportError:
        pbar = None
    t_start = time.perf_counter()
    n_done = 0
    pending = None
    with torch.inference_mode():
        for batch in device_prefetch(loader, device):
            # true division: x * (1/255) differs in the last ulp
            x = batch["image"].float() / 255.0
            preds = model.predict(x, bundle.court_labels, bundle.value_step,
                                  consistency=consistency)
            host, event = _to_host(preds, keep, device)
            if pending is not None:
                write(pending)
            pending = (host, event, batch["name"], batch["num_valid"])
            n_done += batch["num_valid"]
            if pbar is not None:
                pbar.update(batch["num_valid"])
        if pending is not None:
            write(pending)
    elapsed = time.perf_counter() - t_start
    if pbar is not None:
        pbar.close()
    logger.info("Processed {} frames in {:.2f}s ({:.1f} fps)".format(
        n_done, elapsed, n_done / max(elapsed, 1e-9)))

    if records:
        records["model"] = (os.path.basename(os.path.dirname(args.load))
                            if args.load else "uninitialized")
        court_json = os.path.join(args.dst_dir, f"{game_name}_court.json")
        with open(court_json, "w") as f:
            json.dump(records, f, indent=2)
    print("Processing completed!")
    return {"frames": n_done, "seconds": elapsed}


def main():
    process()


if __name__ == "__main__":
    main()
