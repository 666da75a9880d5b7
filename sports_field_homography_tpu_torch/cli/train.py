"""Training CLI (port of ``cli/train.py``: ``main`` and
``prepare_dataloader``) on one device.  Run it with::

    python -m sports_field_homography_tpu_torch.cli.train -c conf.yaml

The conf has the JAX package's keys (``conf/train_reconstructor.yaml.example``);
without PyYAML it must be written as JSON.  Frames, ``mask_dir`` PNG masks
and ``anno_dir`` JSON annotations live in per-game sub-directories;
``val_names`` lists the validation games.  Each epoch writes a
reference-keyed ``CP_epoch{n}.pth`` and the conf as ``conf.yaml`` into
``cp_dir``, which the port's predict CLI loads.  ``--device cpu`` runs the
kernels' plain PyTorch versions; ``compute_dtype: float32`` turns TF32 off.

Not ported yet, and refused with the ROADMAP.md step that brings them:
augmentation, UV ``.tif`` masks, ``--resume``, the SIGTERM save (no
handler is installed), async checkpoints, TensorBoard (``log_dir``,
``--viz``), gradient accumulation, ``tail: pad``, multi-device,
``.msgpack`` import and the torchvision warm start.
"""
from __future__ import annotations

import os
from shutil import copyfile

import torch

from ..data.dataset import BasicDataset, split_on_train_val
from ..data.loader import Loader
from ..train.loop import LossConfig, train_net
from ..utils.config import get_training_args, parse_config, replace_args
from ..utils.logger import get_logger
from .engine import build_model

__all__ = ["main", "prepare_dataloader"]

_STEP = "ROADMAP.md queue 1 step 6"


def _check_slice(args) -> None:
    """Raise on what this port does not do yet, naming its ROADMAP step."""
    todo = []
    if args.aug is not None:
        todo.append("augmentation (aug)")
    if args.unet_uv:
        todo.append("UV .tif masks (unet_uv)")
    if args.resume:
        todo.append("--resume")
    if args.async_ckpt:
        todo.append("--async_ckpt")
    if args.log_dir is not None or args.viz:
        todo.append("TensorBoard logging (log_dir, --viz)")
    if int(args.grad_accum or 1) != 1:
        todo.append("gradient accumulation (--grad_accum)")
    if args.tail == "pad":
        todo.append("tail: pad")
    if args.resnet_pretrained is not None:
        todo.append("--resnet_pretrained")
    if todo:
        raise NotImplementedError(f"{', '.join(todo)}: not ported yet ({_STEP})")
    if args.num_devices not in (None, 1) or args.num_hosts is not None \
            or args.coordinator is not None:
        raise NotImplementedError(
            "--num_devices/--num_hosts: multi-device training is ROADMAP.md "
            "queue 1 step 7")
    for key in ("img_dir", "mask_dir", "anno_dir", "cp_dir"):
        if getattr(args, key) is None:
            raise ValueError(f"{key} is required")


def prepare_dataloader(img_dir, mask_dir, anno_dir, anno_keys, val_names,
                       batch_size, target_size, only_ncaam=False, data_seed=0,
                       num_workers=8):
    """Train and validation loaders: the train order is shuffled from
    ``(data_seed, epoch)``; both yield the true smaller tail batch."""
    train_ids, val_ids = split_on_train_val(img_dir, val_names, only_ncaam)
    train = BasicDataset(sorted(train_ids), img_dir, target_size, mask_dir,
                         anno_dir, anno_keys)
    val = BasicDataset(sorted(val_ids), img_dir, target_size, mask_dir,
                       anno_dir, anno_keys)
    train_loader = Loader(train, batch_size, num_workers=num_workers,
                          shuffle=True, seed=data_seed, pad_last=False)
    val_loader = Loader(val, batch_size, num_workers=num_workers, pad_last=False)
    return train_loader, len(train), val_loader, len(val)


def _as_list(v):
    if isinstance(v, str):
        return [s.strip() for s in v.split(",") if s.strip()]
    return list(v or [])


def main(argv=None, num_data_workers: int = 8) -> dict:
    """Run the CLI; returns ``train_net``'s history plus ``cp_dir``."""
    args = get_training_args(argv)
    if args.conf_path is not None:
        args = replace_args(args, parse_config(args.conf_path))
    _check_slice(args)
    os.makedirs(args.cp_dir, exist_ok=True)
    log_path = os.path.join(os.path.dirname(args.cp_dir.rstrip("/")), "train.txt")
    logger = get_logger(log_path, format="%(message)s")

    bundle = build_model(args, load=args.load)
    model, device = bundle.model, bundle.device
    court_template = bundle.court_labels.float() / float(args.mask_classes)
    court_poi = torch.from_numpy(bundle.court_poi).to(device)
    logger.info(f"""# Reconstructor network overview:
            Target size:      {args.target_size}
            Court img path:   {args.court_img}
            Court img size:   {args.court_size}
            UNet size:        {args.unet_size}
            Mask classes:     {args.mask_classes}
            ResNet name:      {args.resnet_name}
            ResNet input:     {args.resnet_input}
            Warp size:        {args.warp_size}
            Compute dtype:    {args.compute_dtype}
        """)

    train_loader, n_train, val_loader, n_val = prepare_dataloader(
        args.img_dir, args.mask_dir, args.anno_dir, _as_list(args.anno_keys),
        _as_list(args.val_names), args.batchsize, args.target_size,
        args.only_ncaam, args.data_seed, num_data_workers)
    logger.info(f"Dataset: train={n_train} val={n_val}")
    if args.conf_path is not None:
        copyfile(args.conf_path, os.path.join(args.cp_dir, "conf.yaml"))

    # disable losses for missing submodules (reference train.py:428-434)
    if not args.use_unet:
        args.seg_loss = args.consist_loss = None
    if not args.use_resnet:
        args.rec_loss = args.reproj_loss = args.consist_loss = None
    loss_cfg = LossConfig(
        seg_loss=args.seg_loss, rec_loss=args.rec_loss,
        reproj_loss=args.reproj_loss, consist_loss=args.consist_loss,
        seg_lambda=args.seg_lambda, rec_lambda=args.rec_lambda,
        reproj_lambda=args.reproj_lambda, consist_lambda=args.consist_lambda,
        consist_start_iter=args.consist_start_iter, batch_size=args.batchsize,
        weight_semantics=args.weight_semantics)

    history = train_net(
        model, court_template, court_poi, train_loader, n_train,
        val_loader if n_val else None, args.batchsize, args.val_step_n,
        loss_cfg, device, opt=args.opt, epochs=args.epochs, lr=args.lr,
        w_decay=args.weight_decay, target_size=args.target_size,
        cp_dir=args.cp_dir, logger=logger)
    history["cp_dir"] = args.cp_dir
    return history


if __name__ == "__main__":
    main()
