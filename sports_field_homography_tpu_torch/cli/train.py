"""Training CLI (port of ``cli/train.py``: ``main`` and
``prepare_dataloader``), on one device or data parallel.  Run it with::

    python -m sports_field_homography_tpu_torch.cli.train -c conf.yaml

The conf has the JAX package's keys (``conf/train_reconstructor.yaml.example``
runs as written); without PyYAML it must be written as JSON.  Frames,
``mask_dir`` PNG masks (UV ``.tif`` masks with ``unet_uv``) and
``anno_dir`` JSON annotations live in per-game sub-directories;
``val_names`` lists the validation games.  Each epoch writes a
reference-keyed ``CP_epoch{n}.pth`` and the conf as ``conf.yaml`` into
``cp_dir``, which the port's predict CLI loads.  ``--device cpu`` runs the
kernels' plain PyTorch versions; ``compute_dtype: float32`` turns TF32 off.

As in the JAX CLI: ``aug`` (host augmentation, seeded per sample from
``--data_seed``), ``log_dir`` (TensorBoard, where it is installed) and
``--viz``, ``--grad_accum``, ``--async_ckpt``, and ``--resnet_pretrained``
from a local ``.pth``.  ``tail`` is accepted and needs no padding here: the
last train batch is the true smaller one, whose step is exactly what the
JAX package's masked step computes on a padded tail.  SIGTERM or SIGINT
sets a flag; the loop then saves ``last.pth``, ``last_state.pth`` and
``last_state.sched.json`` at the next point between steps and exits 0 (a
second signal exits at once, without a save); ``--resume`` continues from
them exactly where the run stopped.  ``--load`` takes a ``.pth`` or the JAX
package's ``.msgpack``.  Refused up front: orbax directories (convert them
with the JAX package's ``scripts/export_torch_checkpoint.py``), the
torchvision warm start by variant name or URL (it needs a download),
``scale`` augmentation without Pillow and UV masks without cv2.

Data parallel (the JAX CLI's ``--num_devices`` / ``--num_hosts``): one
rank a device, ``--batchsize`` the global batch split evenly over the
ranks (``parallel/distributed.py``, ``train/loop.py``).  ``--num_devices
N`` starts N local ranks (``torch.multiprocessing``; on ``--device cpu`` N
gloo ranks), refused before any starts where the machine has fewer cards;
``--num_hosts H --host_id h --coordinator host:port`` (or ``SFH_*``) makes
this process host h's ranks of H * N.  The train order must be seeded
(``--data_seed``, as in JAX).  Rank 0 writes the checkpoints, the conf
copy and TensorBoard; every rank reads ``--resume``'s state, so
``cp_dir`` must be one directory that every host sees.  SIGTERM to the
``--num_devices`` parent goes to its ranks; a signal that reaches one rank
stops them all after the same step.
"""
from __future__ import annotations

import json
import os
import signal
import sys
from shutil import copyfile

import torch

from ..data.dataset import BasicDataset, split_on_train_val
from ..data.image import have_cv2
from ..data.loader import Loader
from ..models.layers import set_bn_sync
from ..models.resnet import resnet_models
from ..parallel.distributed import free_port, initialize_distributed, resolve_hosts
from ..parallel.mesh import check_batch_divisible, local_devices
from ..train.loop import LossConfig, train_net
from ..utils.checkpoint import atomic_write, save_checkpoint, save_train_state, train_state
from ..utils.config import get_training_args, parse_config, replace_args
from ..utils.logger import get_logger
from .engine import build_model, check_loadable

__all__ = ["main", "prepare_dataloader", "warm_start_resnet"]


def _check_slice(args) -> None:
    """Raise on what this port does not do, before anything is built."""
    if args.num_devices is not None and args.num_devices < 1:
        raise ValueError(f"--num_devices {args.num_devices}")
    check_loadable(args.load)
    pre = args.resnet_pretrained
    if pre is not None and (pre in resnet_models or pre.startswith(("http://", "https://"))):
        raise NotImplementedError(
            f"--resnet_pretrained {pre}: the torchvision weights by variant name or URL "
            "need a download, which this port does not make; download the file and "
            "pass its local .pth path")
    if args.unet_uv and not have_cv2():
        raise RuntimeError("unet_uv: the UV .tif masks are read with cv2, which is "
                           "not installed")
    for key in ("img_dir", "mask_dir", "anno_dir", "cp_dir"):
        if getattr(args, key) is None:
            raise ValueError(f"{key} is required")


def prepare_dataloader(img_dir, mask_dir, anno_dir, anno_keys, val_names,
                       batch_size, target_size, only_ncaam=False, data_seed=0,
                       num_workers=8, aug=None, use_uv=False, uint8_inputs=None,
                       shard=None):
    """Train and validation loaders.  The train order is shuffled from
    ``(data_seed, epoch)`` (``data_seed`` None: unseeded), and so are the
    augmentation parameters.  ``uint8_inputs``: ship train frames as uint8
    (default: unless augmenting, which works on float images); validation
    frames are uint8 unless it is 0.  Both yield their true tail batch.
    ``shard=(rank, world)``: the train loader yields this rank's slice of
    each global batch (every rank validates on the whole set)."""
    train_ids, val_ids = split_on_train_val(img_dir, val_names, only_ncaam)
    train_u8 = bool(uint8_inputs) if uint8_inputs is not None else aug is None
    val_u8 = bool(uint8_inputs) if uint8_inputs is not None else True
    train = BasicDataset(sorted(train_ids), img_dir, target_size, mask_dir,
                         anno_dir, anno_keys, use_uv=use_uv, aug=aug,
                         aug_seed=data_seed, raw_uint8=train_u8)
    val = BasicDataset(sorted(val_ids), img_dir, target_size, mask_dir,
                       anno_dir, anno_keys, use_uv=use_uv, raw_uint8=val_u8)
    train_loader = Loader(train, batch_size, num_workers=num_workers,
                          shuffle=True, seed=data_seed, pad_last=False, shard=shard)
    val_loader = Loader(val, batch_size, num_workers=num_workers, pad_last=False)
    return train_loader, len(train), val_loader, len(val)


def warm_start_resnet(model, path: str, logger) -> None:
    """Load the ResNet STN's weights from a local ``.pth`` (the JAX CLI's
    ``--resnet_pretrained`` merge): a reference-keyed state_dict gives its
    ``resnet_reg.*`` entries; one without reference keys is a torchvision
    ResNet's, whose ``fc`` and ``conv1`` are left out (they do not fit the
    STN's head and input) and the rest taken as ``resnet_reg.*``.  Only
    entries the model has are loaded; BN's ``num_batches_tracked`` is not
    (the JAX package has no such counter)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not any(k.startswith(("inc.", "resnet_reg.")) for k in sd):
        sd = {"resnet_reg." + k: v for k, v in sd.items()
              if not k.startswith(("fc.", "conv1."))}
    own = model.state_dict()
    take = {k: v for k, v in sd.items() if k.startswith("resnet_reg.") and k in own
            and not k.endswith("num_batches_tracked")}
    if take:
        model.load_state_dict(take, strict=False)
        logger.info(f"ResNet warm-start from {path} ({len(take)} tensors)")


def _as_list(v):
    if isinstance(v, str):
        return [s.strip() for s in v.split(",") if s.strip()]
    return list(v or [])


def _resume_sched(args, logger):
    """The data-schedule position to resume at: ``last_state.sched.json``
    in ``cp_dir`` for a seeded run, else None (a ``--data_seed -1`` run
    resumes its state on a fresh shuffle, with a warning)."""
    if not args.resume:
        return None
    if args.data_seed in (None, -1):
        logger.warning(
            "resuming a --data_seed -1 run: the data schedule is "
            "nondeterministic, so this resume continues with a FRESH "
            "shuffle order (not bit-exact vs an uninterrupted run). Use a "
            "seeded --data_seed for exact mid-epoch resume.")
        return None
    path = os.path.join(args.cp_dir, "last_state.sched.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def main(argv=None, num_data_workers: int = 8) -> dict:
    """Run the CLI; returns ``train_net``'s history plus ``cp_dir`` (with
    ``--num_devices`` > 1, which runs the ranks in child processes, only
    ``cp_dir``)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parse(argv)
    hosts = resolve_hosts(args.coordinator, args.num_hosts, args.host_id)
    per_host = int(args.num_devices or 1)
    world = per_host * (hosts[1] if hosts else 1)
    if world == 1:
        return _train(args, num_data_workers)
    devices = local_devices(args.device, per_host)
    check_batch_divisible(args.batchsize, world)
    if args.data_seed in (None, -1):
        raise SystemExit("data-parallel training needs a seeded --data_seed: every rank "
                         "derives the same epoch order from it")
    coordinator = hosts[0] if hosts else f"127.0.0.1:{free_port()}"
    first = hosts[2] * per_host if hosts else 0
    if per_host == 1:
        return _train(args, num_data_workers, (coordinator, world, first, devices[0]))
    _spawn_ranks(argv, num_data_workers, coordinator, world, first, devices)
    return {"cp_dir": args.cp_dir}


def _parse(argv):
    args = get_training_args(argv)
    if args.conf_path is not None:
        args = replace_args(args, parse_config(args.conf_path))
    _check_slice(args)
    return args


def _rank_main(local: int, argv, num_data_workers, coordinator, world, first, devices):
    """A ``--num_devices`` child: local rank ``local`` of this host."""
    _train(_parse(argv), num_data_workers, (coordinator, world, first + local, devices[local]))


def _spawn_ranks(argv, num_data_workers, coordinator, world, first, devices) -> None:
    """Run this host's ranks as spawned children and wait for them; SIGTERM
    to this process goes on to every child (SIGINT from a terminal reaches
    them itself).  A failed rank fails the run: the others are ended."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(
        _rank_main, args=(argv, num_data_workers, coordinator, world, first,
                          [str(d) for d in devices]),
        nprocs=len(devices), join=False, start_method="spawn")

    def forward(signum, frame):
        for p in ctx.processes:
            if p.is_alive():
                os.kill(p.pid, signum)

    prev_term = signal.signal(signal.SIGTERM, forward)
    prev_int = signal.signal(signal.SIGINT, signal.SIG_IGN)
    try:
        while not ctx.join():
            pass
    finally:
        signal.signal(signal.SIGTERM, prev_term)
        signal.signal(signal.SIGINT, prev_int)


def _train(args, num_data_workers: int, rank_of=None) -> dict:
    """Train in this process: on one device, or as one data-parallel rank
    (``rank_of = (coordinator, world, rank, device)``)."""
    replicas = None
    if rank_of is not None:
        coordinator, world, rank, device = rank_of
        args.device = str(device)
        replicas = initialize_distributed(coordinator, world, rank, torch.device(device))
    try:
        return _run(args, num_data_workers, replicas)
    finally:
        if replicas is not None:
            replicas.close()


def _run(args, num_data_workers: int, replicas) -> dict:
    main_rank = replicas is None or replicas.is_main
    os.makedirs(args.cp_dir, exist_ok=True)
    if main_rank:
        log_path = os.path.join(os.path.dirname(args.cp_dir.rstrip("/")), "train.txt")
        logger = get_logger(log_path, format="%(message)s")
    else:
        logger = get_logger(format=f"[rank {replicas.rank}] %(message)s", write_date=False)
    if replicas is not None:
        logger.info(f"Data parallel: rank {replicas.rank} of {replicas.world} on "
                    f"{replicas.device}, backend {replicas.backend}, "
                    f"{args.batchsize // replicas.world} of the global batch of "
                    f"{args.batchsize} a rank")

    grad_accum = int(args.grad_accum or 1)
    aug = json.loads(args.aug) if isinstance(args.aug, str) else args.aug
    data_seed = None if args.data_seed in (None, -1) else int(args.data_seed)
    # before the model: a missing codec is refused here
    train_loader, n_train, val_loader, n_val = prepare_dataloader(
        args.img_dir, args.mask_dir, args.anno_dir, _as_list(args.anno_keys),
        _as_list(args.val_names), args.batchsize, args.target_size,
        args.only_ncaam, data_seed, num_data_workers, aug=aug, use_uv=args.unet_uv,
        uint8_inputs=args.uint8_inputs,
        shard=None if replicas is None else (replicas.rank, replicas.world))

    bundle = build_model(args, load=args.load)
    model, device = bundle.model, bundle.device
    if args.resnet_pretrained and args.load is None:
        warm_start_resnet(model, args.resnet_pretrained, logger)
    set_bn_sync(model, replicas)
    court_template = bundle.court_labels.float() / float(args.mask_classes)
    court_poi = torch.from_numpy(bundle.court_poi).to(device)
    logger.info(f"""# Reconstructor network overview:
            Target size:      {args.target_size}
            Court img path:   {args.court_img}
            Court img size:   {args.court_size}
            UNet size:        {args.unet_size}
            Mask classes:     {args.mask_classes}
            UNet UV:          {args.unet_uv}
            ResNet name:      {args.resnet_name}
            ResNet input:     {args.resnet_input}
            Warp size:        {args.warp_size}
            Compute dtype:    {args.compute_dtype}
        """)
    logger.info(f"Dataset: train={n_train} val={n_val} aug={aug}")
    if args.conf_path is not None and main_rank:
        copyfile(args.conf_path, os.path.join(args.cp_dir, "conf.yaml"))

    # disable losses for missing submodules (reference train.py:428-434)
    if not args.use_unet:
        args.seg_loss = args.consist_loss = None
    if not args.use_resnet:
        args.rec_loss = args.reproj_loss = args.consist_loss = None
    if args.use_resnet and args.rec_loss and not args.reproj_loss:
        logger.info("NOTE: reproj_loss is disabled; the homography head is "
                    "supervised only by rec_loss, which cannot recover from "
                    "off-template warps. Set reproj_loss (e.g. RRMSE) for "
                    "stable theta training.")
    loss_cfg = LossConfig(
        seg_loss=args.seg_loss, rec_loss=args.rec_loss,
        reproj_loss=args.reproj_loss, consist_loss=args.consist_loss,
        uv_loss=args.uv_loss, seg_lambda=args.seg_lambda, rec_lambda=args.rec_lambda,
        reproj_lambda=args.reproj_lambda, consist_lambda=args.consist_lambda,
        uv_lambda=args.uv_lambda, consist_start_iter=args.consist_start_iter,
        batch_size=args.batchsize, weight_semantics=args.weight_semantics)

    def save_model():
        """The interrupt save (rank 0 writes it, the other ranks wait for
        it), then exit 0."""
        if main_rank:
            s = state_holder["state"]
            path = os.path.join(args.cp_dir, "last.pth")
            save_checkpoint(path, s["model"])
            save_train_state(os.path.join(args.cp_dir, "last_state.pth"), train_state(**s))
            atomic_write(os.path.join(args.cp_dir, "last_state.sched.json"),
                         json.dumps(state_holder["sched"]).encode())
            logger.info("Saved interrupt to {}".format(path))
        if replicas is not None:
            replicas.barrier()
        sys.exit(0)

    state_holder = {"state": None, "save_and_exit": save_model}

    def request_interrupt(signum=None, frame=None):
        """SIGTERM/SIGINT: the loop saves at its next point between steps,
        where no step is half applied, and exits 0.  A second signal exits
        at once, without a save."""
        if state_holder.get("interrupt"):
            logger.warning("Second interrupt: exiting without a save.")
            os._exit(1)
        if state_holder["state"] is None and replicas is None:   # nothing trained yet
            sys.exit(0)
        state_holder["interrupt"] = True
        logger.info("Interrupt requested: finishing the in-flight step, "
                    "then saving the interrupt checkpoint...")

    if grad_accum > 1:
        logger.info(f"Gradient accumulation: {grad_accum} micro-batches per optimizer "
                    f"step (effective batch {grad_accum * args.batchsize})")
    resume_sched = _resume_sched(args, logger)
    prev_term = signal.signal(signal.SIGTERM, request_interrupt)
    prev_int = signal.signal(signal.SIGINT, request_interrupt)
    try:
        history = train_net(
            model, court_template, court_poi, train_loader, n_train,
            val_loader if n_val else None, args.batchsize,
            args.val_step_n, loss_cfg, device, opt=args.opt, epochs=args.epochs,
            lr=args.lr, w_decay=args.weight_decay, target_size=args.target_size,
            cp_dir=args.cp_dir, logger=logger, log_dir=args.log_dir,
            vizualize=args.viz, state_holder=state_holder,
            resume_state_path=(os.path.join(args.cp_dir, "last_state.pth")
                               if args.resume else None),
            async_ckpt=args.async_ckpt, grad_accum=grad_accum, resume_sched=resume_sched,
            replicas=replicas)
    finally:
        # in-process callers (tests) must not keep the handlers installed
        signal.signal(signal.SIGTERM, prev_term)
        signal.signal(signal.SIGINT, prev_int)
    if train_loader.dropped:
        logger.info(f"Data parallel: {train_loader.dropped} tail batch(es) with fewer "
                    f"samples than the {replicas.world} ranks were skipped")
    history["cp_dir"] = args.cp_dir
    return history


if __name__ == "__main__":
    main()
