"""Batch-inference CLI: image directory or video -> theta, masks, points of
interest and consistency score (port of ``cli/predict.py``).

Same flags, output layout and file formats as the JAX CLI: the records go
to a part JSONL, ``{game}_court_processing.json``, merged at the end into
``{game}_court.json`` (``{name: {"score", "theta", "poi"}}`` plus
``"model"``); the masks, nearest-resized to ``--out_size``, to
``court/{segm,warp}_mask/<name>.png`` or to the pickled PNG-buffer stream
``court/{segm,warp}_mask/data.pkl``; the debug renders to
``court/debug/<name>.jpeg``.  Run it with::

    python -m sports_field_homography_tpu_torch.cli.predict \\
        --img_dir frames/ --load ckpt/model.pth --dst_dir out/ \\
        --req_outputs theta,consistency,segm_mask,warp_mask,poi

Pipeline: a threaded decode loader, pinned non-blocking copies to the
device two batches ahead, the device program of ``engine.predict_fn``
(only the kept outputs, masks as uint8, are copied back, without
blocking), and one writer thread behind a bounded queue that waits on each
batch's copy event, then converts, resizes, encodes and writes, so the
host never waits on the batch it just launched.  ``--resume`` skips the
frames an interrupted run already recorded in the part JSONL.  The video
source and the debug renders need cv2; everything else runs with torch
and numpy alone.

Several devices and hosts, as the JAX CLI: ``--num_devices N`` splits each
batch over N local cards, a copy of the model a card
(``parallel/mesh.shard_predict_fn``; ``--batchsize`` a multiple of N, no
collective); ``--num_hosts H --host_id h --coordinator host:port`` (or the
``SFH_*`` variables) makes this process host h of H: it predicts its
contiguous slice of the frames (``_host_slice``), writes its own part files
(``{game}_court_processing.json.h{h}``, ``data.pkl.h{h}``; ``--resume``
finishes its own part), and after a barrier host 0 merges the JSONL parts
into ``{game}_court.json`` and concatenates the pickle parts.  The hosts
must share ``--dst_dir``.
"""
from __future__ import annotations

import json
import os
import pickle
import queue
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data.dataset import BasicDataset, VideoDataset
from ..data.image import have_cv2
from ..data.loader import Loader, device_prefetch
from ..data.png import encode_png
from ..parallel.distributed import initialize_distributed, resolve_hosts
from ..parallel.mesh import check_batch_divisible, local_devices, shard_predict_fn
from ..utils import trace
from ..utils.config import get_prediction_args, parse_config, replace_args
from ..utils.logger import get_logger
from ..utils.postprocess import draw_text, onehot_to_image, overlay
from .engine import build_model, discover_conf, predict_fn

__all__ = ["process", "main"]

_CONF_IGNORE = ["conf_path", "batchsize", "court_img", "court_poi", "img_dir",
                "court_size", "warp_size", "load", "compute_dtype",
                "num_devices", "resume"]
_MASK_TYPES = ("gray", "bin", "rgb")
_MASK_FORMATS = ("png", "pickle")
_WRITE_QUEUE = 8          # batches waiting for the writer thread


def _check_slice(args, req_outputs) -> None:
    """Raise, before any model is built, on what this port does not do."""
    if args.num_devices is not None and args.num_devices < 1:
        raise ValueError(f"--num_devices {args.num_devices}")
    if {"segm_mask", "warp_mask", "debug"} & set(req_outputs):
        if args.mask_type not in _MASK_TYPES:
            raise NotImplementedError(f"--mask_type {args.mask_type}")
        if args.mask_save_format not in _MASK_FORMATS:
            raise NotImplementedError(f"--mask_save_format {args.mask_save_format}")
    for what, wanted in (("--req_outputs debug", "debug" in req_outputs),
                         ("--video_path", bool(args.video_path))):
        if wanted and not have_cv2():
            raise RuntimeError(f"{what} needs cv2 (opencv-python), which is not "
                               "installed; the other outputs run without it")
    if args.img_dir is None and not args.video_path:
        raise ValueError("--img_dir or --video_path is required")


def _to_host(preds, device):
    """Start copying ``preds`` to the host; returns (tensors, event or
    None).  On CUDA the copies go to pinned memory and an event marks
    their completion."""
    with trace.span("predict.to_host"):
        if device.type != "cuda":
            return {k: v.clone() for k, v in preds.items()}, None
        host = {}
        for k, v in preds.items():
            host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host[k].copy_(v, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event


def _cv2_nearest_index(src: int, dst: int) -> np.ndarray:
    """Source indices of cv2 ``INTER_NEAREST`` along one axis:
    ``min(floor(x * (1 / (dst / src))), src - 1)`` in float64, as
    ``cv2.resize`` computes them (not PIL's centre rule,
    ``data/assets._pil_nearest_index``)."""
    ifx = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * ifx).astype(np.int64), src - 1)


def _resize_masks(masks: np.ndarray, out_size) -> np.ndarray:
    """Nearest-resize (B, H, W[, 3]) masks to ``out_size`` = (W, H), equal
    to ``cv2.resize(m, out_size, interpolation=cv2.INTER_NEAREST)`` per
    mask.  Always applied, as in the JAX and reference CLIs."""
    rows = _cv2_nearest_index(masks.shape[1], int(out_size[1]))
    cols = _cv2_nearest_index(masks.shape[2], int(out_size[0]))
    return masks[:, rows[:, None], cols[None, :]]


def _png_bytes(mask: np.ndarray) -> bytes:
    """A mask's PNG as ``cv2.imencode`` would write it: a 3-channel mask
    is BGR (``onehot_to_image``), stored as RGB."""
    return encode_png(mask[..., ::-1] if mask.ndim == 3 else mask)


def save_mask_as_png(mask: np.ndarray, dst_dir: str, name: str, postfix: str = "mask"):
    dst_subdir = os.path.join(dst_dir, postfix)
    os.makedirs(dst_subdir, exist_ok=True)
    with open(os.path.join(dst_subdir, name + ".png"), "wb") as f:
        f.write(_png_bytes(mask))


def _truncate_torn_pickle(path: str) -> None:
    """Drop a torn trailing record from a pickle stream (a crash in the
    middle of a ``pickle.dump``), so that appends stay readable.  The torn
    frame is predicted again (resume is at least once; readers keep the
    last of duplicate records)."""
    good = 0
    with open(path, "rb") as f:
        try:
            while True:
                pickle.load(f)
                good = f.tell()
        except Exception:   # any unpickling error marks the torn tail
            pass
    if good < os.path.getsize(path):
        with open(path, "rb+") as f:
            f.truncate(good)


class PickleMaskWriter:
    """``<dst>/<postfix>/data.pkl``: one pickled ``[name, buf]`` per mask,
    ``buf`` the PNG's bytes as an (n, 1) uint8 array, as cv2 4's
    ``imencode`` returns it (``cv2.imdecode`` reads it).  ``append`` (resume) extends the stream after dropping a
    torn tail record."""

    def __init__(self, dst_dir: str, postfix: str = "mask", append: bool = False,
                 suffix: str = ""):
        # suffix: a host's part (".h{pid}"), concatenated into data.pkl by host 0
        dst_subdir = os.path.join(dst_dir, postfix)
        os.makedirs(dst_subdir, exist_ok=True)
        path = os.path.join(dst_subdir, "data.pkl" + suffix)
        if append and os.path.exists(path):
            _truncate_torn_pickle(path)
        self.file = open(path, "ab" if append else "wb+")

    def write(self, name: str, mask: np.ndarray) -> None:
        buf = np.frombuffer(_png_bytes(mask), np.uint8).reshape(-1, 1)
        pickle.dump([name, buf], self.file)

    def flush(self) -> None:
        self.file.flush()

    def close(self) -> None:
        self.file.close()


class _IndexView:
    """The dataset at the given indices (``--resume``: the frames not yet
    recorded)."""

    def __init__(self, base, indices):
        self.base, self.indices = base, list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.base[self.indices[i]]


def _read_resume_names(path: str) -> set:
    """The frame names an interrupted run recorded in the part JSONL.

    From the first line that does not parse (a record torn by the crash)
    on, everything is dropped, and the file is rewritten as the clean
    prefix, each line ending in a newline, so that appends never join a
    torn record.  Frames whose records were lost are predicted again.
    """
    if not os.path.exists(path):
        return set()
    names, good = set(), []
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                break
            names.update(rec.keys())
            good.append(line if line.endswith("\n") else line + "\n")
    with open(path, "w") as f:
        f.writelines(good)
    return names


def _host_slice(n: int, pid: int, nproc: int):
    """Contiguous per-host [lo, hi) slice of n frames; both ends clamped, so
    a host beyond the frames gets an empty slice and still reaches the
    end-of-run barrier."""
    per = (n + nproc - 1) // nproc
    lo = min(pid * per, n)
    return lo, min(lo + per, n)


def _merge_pickle_parts(dst_dir: str, nproc: int) -> None:
    """Concatenate the hosts' ``data.pkl.h{p}`` streams into ``data.pkl``
    (pickle streams concatenate losslessly) and remove them."""
    for postfix in ("court/segm_mask", "court/warp_mask"):
        pkl = os.path.join(dst_dir, postfix, "data.pkl")
        parts = [pkl + f".h{p}" for p in range(nproc) if os.path.exists(pkl + f".h{p}")]
        if parts:
            with open(pkl, "wb") as out:
                for part in parts:
                    with open(part, "rb") as f:
                        out.write(f.read())
                    os.remove(part)


def _merge_jsonl_parts(parts, dst_path: str, model_name: str) -> None:
    """Merge the part JSONL files into ``{game}_court.json`` and remove
    them."""
    output = {}
    for part in parts:
        if not os.path.exists(part):
            continue
        with open(part) as f:
            for line in f:
                output.update(json.loads(line))
        os.remove(part)
    if output:
        output["model"] = model_name
        with open(dst_path, "w") as f:
            json.dump(output, f, indent=2)


class _OutputWriter:
    """The writer thread: takes each batch's host outputs from a bounded
    queue, waits on its copy event, and writes masks, JSONL records and
    debug renders.  ``busy_seconds`` counts its time after the waits."""

    def __init__(self, args, req_outputs, json_path: str, resume: bool,
                 part_suffix: str = ""):
        self.args = args
        self.part_suffix = part_suffix
        self.debug = "debug" in req_outputs
        self.json_path = json_path
        self.resume = resume
        self.json_file = None
        self.pickles: Dict[str, PickleMaskWriter] = {}
        self.error: Optional[BaseException] = None
        self.busy_seconds = 0.0
        self.queue: "queue.Queue" = queue.Queue(maxsize=_WRITE_QUEUE)
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name="sfh-predict-writer")
        self.thread.start()

    def put(self, host, event, names, orig_img) -> None:
        if self.error is not None:
            raise self.error
        self.queue.put((host, event, names, orig_img))

    def finish(self) -> None:
        """Drain the queue, join the thread, close the files; re-raise the
        thread's error."""
        self.queue.put(None)
        self.thread.join()
        for w in self.pickles.values():
            w.close()
        if self.json_file is not None:
            self.json_file.close()
        if self.error is not None:
            raise self.error

    def _loop(self) -> None:
        while True:
            item = self.queue.get()
            if item is None:
                return
            if self.error is not None:
                continue        # keep draining so that put() never blocks forever
            try:
                self._write(*item)
            except BaseException as e:  # re-raised in the main thread
                self.error = e

    def _pickle(self, postfix: str) -> PickleMaskWriter:
        if postfix not in self.pickles:
            self.pickles[postfix] = PickleMaskWriter(self.args.dst_dir, postfix,
                                                     append=self.resume,
                                                     suffix=self.part_suffix)
        return self.pickles[postfix]

    def _write(self, host, event, names, orig_img) -> None:
        if event is not None:
            event.synchronize()
        t0 = time.perf_counter()
        args = self.args
        out = {k: v[:len(names)].numpy() for k, v in host.items()}
        masks = {}
        for key in ("segm_mask", "warp_mask"):
            m = out.get(key)
            if m is None:
                continue
            if args.mask_type == "rgb":
                m = onehot_to_image(m, args.mask_classes)
            elif args.mask_type == "bin":
                m = ((m > 0) * 255).astype(np.uint8)
            masks[key] = _resize_masks(m, args.out_size)
        theta, score, poi = out.get("theta"), out.get("consist_score"), out.get("poi")

        records = []
        for i, n in enumerate(names):
            t = n.split("/")
            name = t[1] if len(t) == 2 else t[0]
            for key, m in masks.items():
                postfix = "court/" + key
                if args.mask_save_format == "png":
                    save_mask_as_png(m[i], args.dst_dir, name, postfix=postfix)
                else:
                    self._pickle(postfix).write(name, m[i])
            if theta is not None or score is not None or poi is not None:
                rec = {}
                if score is not None:
                    rec["score"] = float("{:5f}".format(score[i]))
                if theta is not None:
                    rec["theta"] = theta[i].tolist()
                if poi is not None:
                    rec["poi"] = poi[i].tolist()
                records.append({name: rec})
            if self.debug:      # over the warp mask, which debug always keeps
                self._write_debug(orig_img[i], name, masks["warp_mask"][i],
                                  None if score is None else score[i],
                                  None if poi is None else poi[i])

        # a frame's record (the resume ledger) must never reach the disk
        # before its masks: flush the pickle streams, then write and flush
        # this batch's records
        if records:
            for w in self.pickles.values():
                w.flush()
            if self.json_file is None:
                self.json_file = open(self.json_path, "a" if self.resume else "w+")
            for rec in records:
                json.dump(rec, self.json_file)
                self.json_file.write("\n")
            self.json_file.flush()
        self.busy_seconds += time.perf_counter() - t0

    def _write_debug(self, orig_img, name, mask, score, poi) -> None:
        """The frame with the warp mask blended over it, the points of
        interest numbered and the score, as a quality-90 JPEG."""
        import cv2

        args = self.args
        orig_img = np.asarray(orig_img)
        if mask.shape[0:2] != orig_img.shape[0:2]:
            mask = cv2.resize(mask, (orig_img.shape[1], orig_img.shape[0]),
                              interpolation=cv2.INTER_NEAREST)
        if args.mask_type != "rgb":
            mask = onehot_to_image(mask, args.mask_classes)[0]
        debug_img = overlay(orig_img, mask)
        if poi is not None:
            img_h, img_w = orig_img.shape[0:2]
            for pi, pts in enumerate(poi):
                # poi are in [0, 1]: keep the points inside the frame
                if not (0.0 <= pts[0] < 1.0 and 0.0 <= pts[1] < 1.0):
                    continue
                x, y = int(round(pts[0] * img_w)), int(round(pts[1] * img_h))
                debug_img = cv2.circle(debug_img, (x, y), 3, color=(255, 255, 255),
                                       thickness=2)
                draw_text(debug_img, text=str(pi), pos=(x + 3, y + 3),
                          color=(128, 128, 255), scale=1)
        if score is not None:
            draw_text(debug_img, text="{:4f}".format(score), pos=(15, 15),
                      color=(0, 255, 0), scale=0.75)
        dst_subdir = os.path.join(args.dst_dir, "court/debug")
        os.makedirs(dst_subdir, exist_ok=True)
        cv2.imwrite(os.path.join(dst_subdir, name + ".jpeg"), debug_img,
                    [cv2.IMWRITE_JPEG_QUALITY, 90])


def process(argv=None, num_data_workers: int = 4) -> dict:
    """Run the CLI; returns ``{"frames": n, "seconds": t, "writer_seconds":
    w}``: the frames predicted, the loop's seconds (the writer's last
    batch included) and the writer thread's busy seconds."""
    args = get_prediction_args(argv)
    hosts = resolve_hosts(args.coordinator, args.num_hosts, args.host_id)
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
    devices = None
    if args.num_devices is not None and args.num_devices > 1:
        devices = local_devices(args.device, args.num_devices)
        check_batch_divisible(args.batchsize, args.num_devices)
        args.device = str(devices[0])
    debug = "debug" in req_outputs
    if debug and "warp_mask" not in req_outputs:
        req_outputs.append("warp_mask")
    consistency = "consistency" in req_outputs
    keep = [k for k in ("segm_mask", "warp_mask", "theta", "poi") if k in req_outputs]
    if consistency:
        keep.append("consist_score")
    args.use_warper = "warp_mask" in req_outputs or consistency
    if consistency and not args.use_unet:
        raise ValueError("consistency needs the UNet")
    if "poi" in req_outputs and not args.use_warper:
        raise ValueError("poi needs the warper: ask for warp_mask or consistency too")
    os.makedirs(args.dst_dir, exist_ok=True)
    if args.video_path:
        game_name = os.path.basename(os.path.dirname(args.video_path))
    else:
        game_name = os.path.basename(args.img_dir)
    logger = get_logger(format="%(message)s", write_date=False)

    # the hosts meet only at the end-of-run barrier: no collective in between
    replicas = None
    if hosts is not None and hosts[1] > 1:
        replicas = initialize_distributed(hosts[0], hosts[1], hosts[2],
                                          torch.device(args.device))
        print(f"predict host {replicas.rank} of {replicas.world} (backend "
              f"{replicas.backend})")
    try:
        return _predict(args, req_outputs, keep, consistency, debug, game_name, logger,
                        devices, replicas, num_data_workers)
    finally:
        if replicas is not None:
            replicas.close()


def _predict(args, req_outputs, keep, consistency, debug, game_name, logger, devices,
             replicas, num_data_workers):
    bundle = build_model(args, load=args.load, fold_bn=bool(args.fold_bn))
    device = bundle.device
    if args.img_dir is not None:
        ids = sorted(n for n in os.listdir(args.img_dir)
                     if os.path.isfile(os.path.join(args.img_dir, n)))
        data = BasicDataset(ids, args.img_dir, target_size=args.target_size,
                            keep_orig_img=debug)
        loader_workers = num_data_workers
    else:
        data = VideoDataset(args.video_path, target_size=args.target_size,
                            keep_orig_img=debug, decode_workers=args.video_workers)
        loader_workers = 1      # sequential decode wants in-order access
    source = data
    n_all = len(data)
    lo, hi = 0, n_all
    part_suffix = ""
    if replicas is not None:
        lo, hi = _host_slice(n_all, replicas.rank, replicas.world)
        part_suffix = f".h{replicas.rank}"
        print(f"host {replicas.rank}: frames [{lo}, {hi}), {hi - lo} local")

    # --resume: skip the frames an interrupted run recorded in the part
    # JSONL (this host's own part) and append to it (their masks are on disk)
    part_base = os.path.join(args.dst_dir, f"{game_name}_court_processing.json")
    json_path = part_base + part_suffix
    resume = bool(args.resume)
    done = _read_resume_names(json_path) if resume else set()
    n_slice = hi - lo
    if args.img_dir is not None:
        todo = [i for i in range(lo, hi) if ids[i][: ids[i].rfind(".")] not in done]
    else:
        # video frames are recorded in order: skip the done prefix
        while lo < hi and str(lo).zfill(6) in done:
            lo += 1
        if (lo, hi) != (0, n_all):
            data.set_range(lo, hi)
        todo = range(lo, hi)
    if len(todo) != n_all:
        data = _IndexView(data, todo)
    if done:
        logger.info(f"--resume: {n_slice - len(data)} frames already in "
                    f"{os.path.basename(json_path)}, {len(data)} left to predict")
    loader = Loader(data, args.batchsize, num_workers=loader_workers)
    logger.info(f"""Start making predictions:
            Model file:        {args.load}
            Device:            {device if devices is None else [str(d) for d in devices]}
            Compute dtype:     {args.compute_dtype}
            Images dir:        {args.img_dir}
            Video path:        {args.video_path}
            Num images:        {len(data)}
            Batch size:        {args.batchsize}
            Dest dir:          {args.dst_dir}
            Required outputs:  {req_outputs}
            Mask type:         {args.mask_type}
            Mask save format:  {args.mask_save_format}
            ResNet input size: {args.target_size}
            UNET input size:   {args.unet_size}
            Court img size:    {args.court_size}
            Warping size:      {args.warp_size}
            Output size:       {args.out_size}
        """)

    predict = (predict_fn(bundle, consistency, keep) if devices is None
               else shard_predict_fn(bundle, devices, consistency, keep))
    try:
        from tqdm import tqdm
        pbar = tqdm(total=len(data), desc="Processing", unit="img")
    except ImportError:
        pbar = None
    t_start = time.perf_counter()
    n_done = 0
    writer = _OutputWriter(args, req_outputs, json_path, resume, part_suffix)
    try:
        with torch.inference_mode():
            for batch in device_prefetch(loader, device):
                nv = batch["num_valid"]
                host, event = _to_host(predict(batch["image"]), device)
                writer.put(host, event, batch["name"][:nv], batch.get("orig_img"))
                n_done += nv
                if pbar is not None:
                    pbar.update(nv)
    finally:
        writer.finish()
        if isinstance(source, VideoDataset):
            source.close()
    elapsed = time.perf_counter() - t_start
    if pbar is not None:
        pbar.close()
    logger.info("Processed {} frames in {:.2f}s ({:.1f} fps)".format(
        n_done, elapsed, n_done / max(elapsed, 1e-9)))

    model_name = (os.path.basename(os.path.dirname(args.load))
                  if args.load else "uninitialized")
    court_json = os.path.join(args.dst_dir, f"{game_name}_court.json")
    if replicas is not None:
        # every host's parts are on disk; then host 0 merges them
        replicas.barrier()
        if replicas.is_main:
            _merge_jsonl_parts([part_base + f".h{p}" for p in range(replicas.world)],
                               court_json, model_name)
            _merge_pickle_parts(args.dst_dir, replicas.world)
    elif writer.json_file is not None or (resume and os.path.exists(json_path)):
        # with resume also when nothing was left: the part still needs merging
        _merge_jsonl_parts([json_path], court_json, model_name)
    print("Processing completed!")
    return {"frames": n_done, "seconds": elapsed, "writer_seconds": writer.busy_seconds}


def main():
    process()


if __name__ == "__main__":
    main()
