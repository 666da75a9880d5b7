"""Checkpoint-sweep test CLI (port of ``cli/test.py``).  Run it with::

    python -m sports_field_homography_tpu_torch.cli.test \\
        --cp_dir run/ --test_epochs 1,2,5 --img_dir frames/ \\
        --mask_dir masks/ --anno_dir anno/

For each epoch it loads ``CP_epoch{n}.msgpack`` (the JAX package's) or
``CP_epoch{n}.pth`` from ``cp_dir``, the first it finds, and the
``conf.yaml`` beside it (the train CLI writes both; without PyYAML the conf
must be JSON, which the train CLI's JSON confs are), scores the model on
every game sub-directory of ``img_dir`` with the nearest warp (K1 on the
full ``warp_size`` grid), unweighted means and reprojection in pixels at
``--metric_img_size``, and appends the four scores and the elapsed
milliseconds to ``test_scores.txt`` beside the checkpoint, in the JAX
CLI's format (the input of ``utils/viz_metrics.py``).  ``--device cpu``
runs the kernels' plain versions; ``--compute_dtype float32`` turns TF32
off.  ``.orbax`` directories are refused: convert them with the JAX
package's ``scripts/export_torch_checkpoint.py``.
"""
from __future__ import annotations

import os
import time

import torch

from ..data.dataset import BasicDataset, split_on_train_val
from ..data.loader import Loader, device_prefetch
from ..train.evaluate import eval_reconstructor
from ..utils.config import get_test_args, parse_config, replace_args
from ..utils.logger import get_logger
from .engine import build_model

__all__ = ["test", "main"]

# the JAX CLI's ignore list, plus the port's device (a run-time choice)
_CONF_IGNORE = ["img_dir", "mask_dir", "anno_dir", "batchsize", "load",
                "court_img", "court_poi", "compute_dtype", "num_devices", "device"]


def test(args, num_data_workers: int = 8) -> dict:
    """Score the checkpoint ``args.load``; returns the eval result plus
    ``elapsed_ms``."""
    conf_path = os.path.join(os.path.dirname(args.load), "conf.yaml")
    if not os.path.isfile(conf_path):
        raise FileNotFoundError(f"{conf_path}: the test CLI reads the conf "
                                "beside the checkpoint")
    print("Reading params from {}...".format(conf_path))
    args = replace_args(args, parse_config(conf_path), ignore_keys=_CONF_IGNORE)
    args.resnet_pretrained = None
    args.anno_keys = ["poi"]
    args.log_path = os.path.join(os.path.dirname(args.load), "test_scores.txt")
    logger = get_logger(args.log_path, format="%(message)s")

    bundle = build_model(args, load=args.load, warp_with_nearest=True,
                         fold_bn=bool(getattr(args, "fold_bn", 1)))
    model, device = bundle.model, bundle.device
    test_ids, _ = split_on_train_val(args.img_dir, val_names=[])
    data = BasicDataset(test_ids, args.img_dir, args.target_size, args.mask_dir,
                        args.anno_dir, args.anno_keys)
    loader = Loader(data, args.batchsize, num_workers=num_data_workers, pad_last=False)
    logger.info(f"""Starting testing:
            Model file:      {args.load}
            Images dir:      {args.img_dir}
            Masks dir:       {args.mask_dir}
            Annotation dir:  {args.anno_dir}
            Logs file:       {args.log_path}
            Batch size:      {args.batchsize}
            Test size:       {len(data)}
            Device:          {device}
            Target size:     {args.target_size}
            UNET input size: {args.unet_size}
            Bilinear:        {args.unet_bilinear}
            Mask classes:    {args.mask_classes}
            ResNetSTN:       {args.resnet_name}
            Resnet Input:    {args.resnet_input}
            Metric img size: {args.metric_img_size}
        """)

    court_template = bundle.court_labels.float() / float(args.mask_classes)
    court_poi = torch.from_numpy(bundle.court_poi).to(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()          # a device-synchronised wall clock
    start = time.perf_counter()
    result = eval_reconstructor(model, device_prefetch(loader, device), court_template,
                                court_poi, args.metric_img_size,
                                use_per_sample_weights=False,
                                court_labels=(bundle.court_labels, bundle.value_table))
    sync()
    elapsed_ms = (time.perf_counter() - start) * 1000.0

    logger.info(f"""Test scores:
            Reprojection px:     {result['val_reproj_px']}
            Reprojection RMSE:   {result['val_reproj_score']}
            Segmentation CE:     {result['val_seg_score']}
            Reconstruction MSE:  {result['val_rec_score']}
            Elapsed msec:        {elapsed_ms}
        """)
    print("All done!")
    return dict(result, elapsed_ms=elapsed_ms)


def main(argv=None, num_data_workers: int = 8) -> dict:
    """Test each epoch of ``--test_epochs``; returns {epoch: result}."""
    args = get_test_args(argv)
    results = {}
    for e in args.test_epochs.split(","):
        for ext in (".msgpack", ".pth", ".orbax"):
            path = os.path.join(args.cp_dir, "CP_epoch{}{}".format(e, ext))
            if os.path.exists(path):
                args.load = path
                break
        else:
            print("Model file not found for epoch {}".format(e))
            continue
        results[e] = test(args, num_data_workers)
    return results


if __name__ == "__main__":
    main()
