"""Argparse + YAML-overlay configuration (port of ``utils/config.py``:
the prediction, training, checkpoint-test and serving arguments).

Same flag names and defaults as the JAX package, and the same overlay:
a ``conf.yaml`` beside the checkpoint replaces parsed values key by key
(``replace_args``), except for the keys a caller lists to ignore.  The TPU
kernel switches (``--warp_kernel``, ``--conv_kernel``, ``--fused_bn``) are
not carried over: the port always runs its CUDA kernels on a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os

__all__ = ["parse_config", "get_prediction_args", "get_training_args",
           "get_test_args", "get_serving_args", "replace_args", "resolve_asset"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def resolve_asset(path: str) -> str:
    """Resolve ``./assets/...`` defaults against the checkout root when they
    do not exist relative to the working directory."""
    if path and not os.path.exists(path):
        candidate = os.path.join(_REPO_ROOT, path.lstrip("./"))
        if os.path.exists(candidate):
            return candidate
    return path


def parse_config(path_to_yaml: str):
    """Parse a YAML config file; ``None`` (with a message) if unreadable.

    A JSON document (JSON is valid YAML) is read by JSON's rules, so that
    ``1e-06`` is a number as JSON means it (PyYAML's YAML 1.1 reads it as
    a string).  Anything else needs PyYAML; without it a ``RuntimeError``
    says that the file must be JSON.
    """
    try:
        with open(path_to_yaml, "r") as file:
            text = file.read()
    except OSError:
        print("Error reading the config file:", path_to_yaml)
        return None
    try:
        return json.loads(text)
    except json.JSONDecodeError as e:
        json_error = e
    try:
        import yaml
    except ImportError:
        raise RuntimeError(
            f"{path_to_yaml}: PyYAML is not installed, so the config must be "
            f"JSON (which is valid YAML), and this file is not: {json_error}"
        ) from None
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        print("Error reading the config file:", path_to_yaml)
        return None


def _base_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Reconstructor (PyTorch)")
    parser.add_argument("--load", dest="load", type=str, default=None,
                        help="Load model from a reference-keyed .pth state_dict "
                             "or the JAX package's .msgpack")
    parser.add_argument("--conf_path", "-c", dest="conf_path", type=str,
                        default=None, help="Load config from a .yaml file")
    parser.add_argument("--batchsize", "-bs", dest="batchsize", type=int,
                        default=8, help="Batch size")
    parser.add_argument("--img_dir", dest="img_dir", type=str, default=None,
                        help="Directory of frames")
    parser.add_argument("--court_img", dest="court_img", type=str,
                        default="./assets/pitch_mask_nc4_hd_onehot.png",
                        help="Court template image warped by the homography")
    parser.add_argument("--court_poi", dest="court_poi", type=str,
                        default="./assets/template_pitch_points.json",
                        help="Court points of interest")
    # resolutions (W, H); set through conf.yaml
    parser.add_argument("--target_size", dest="target_size", default=(640, 360))
    parser.add_argument("--unet_size", dest="unet_size", default=(640, 360))
    parser.add_argument("--warp_size", dest="warp_size", default=(640, 360))
    parser.add_argument("--court_size", dest="court_size", default=(640, 360))
    parser.add_argument("--use_unet", action="store_true", default=True)
    parser.add_argument("--unet_bilinear", action="store_true", default=False)
    parser.add_argument("--mask_classes", dest="mask_classes", type=int,
                        default=4)
    parser.add_argument("--unet_uv", action="store_true", default=False)
    parser.add_argument("--use_resnet", action="store_true", default=True)
    parser.add_argument("--resnet_name", type=str, default="resnet34")
    parser.add_argument("--resnet_input", type=str, default="img+mask")
    parser.add_argument("--use_warper", action="store_true", default=True)
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        help="bfloat16 (fast) or float32 (parity; TF32 off)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain "
                             "PyTorch versions")
    # accepted so the JAX package's command lines parse; not ported yet
    parser.add_argument("--num_devices", type=int, default=None)
    parser.add_argument("--num_hosts", type=int, default=None)
    parser.add_argument("--host_id", type=int, default=None)
    parser.add_argument("--coordinator", type=str, default=None)
    return parser


def get_prediction_args(argv=None):
    """Prediction arguments (the JAX package's ``get_prediction_args``)."""
    parser = _base_parser()
    parser.add_argument("--video_path", type=str, default=None,
                        help="Video file to read frames from (needs cv2)")
    parser.add_argument("--video_workers", type=int, default=1,
                        help="Video decode threads, each on a contiguous chunk")
    parser.add_argument("--dst_dir", type=str, default=None,
                        help="Directory where the results will be saved")
    parser.add_argument("--req_outputs", type=str,
                        default="segm_mask,warp_mask,theta,poi,consistency,debug",
                        help="Outputs to compute and save: segm_mask, "
                             "warp_mask, theta, poi, consistency, debug "
                             "(debug needs cv2)")
    parser.add_argument("--out_size", default=(1280, 720), nargs="+", type=int,
                        help="Output images size")
    parser.add_argument("--mask_type", type=str, default="gray")
    parser.add_argument("--mask_save_format", type=str, default="pickle")
    parser.add_argument("--fold_bn", type=int, default=1,
                        help="Fold BatchNorm into conv weights at load "
                             "(inference-only; 0 disables)")
    parser.add_argument("--resume", action="store_true", default=False)
    return parser.parse_args(argv)


def _training_parser() -> argparse.ArgumentParser:
    parser = _base_parser()
    parser.add_argument("--viz", action="store_true", default=False)
    parser.add_argument("--resnet_pretrained", type=str, default=None,
                        help="Warm-start the ResNet STN from a local .pth: a "
                             "reference-keyed state_dict, or a torchvision "
                             "ResNet's (fc and conv1 are left out)")
    parser.add_argument("--mask_dir", dest="mask_dir", type=str, default=None)
    parser.add_argument("--anno_dir", dest="anno_dir", type=str, default=None)
    parser.add_argument("--anno_keys", dest="anno_keys", type=str, default=None)
    parser.add_argument("--val_names", dest="val_names", type=str, default=None)
    parser.add_argument("--aug", dest="aug", type=str, default=None)
    parser.add_argument("--only_ncaam", action="store_true", default=False)
    parser.add_argument("--opt", dest="opt", type=str, default="RMSprop")
    parser.add_argument("--epochs", dest="epochs", type=int, default=8)
    parser.add_argument("--lr", dest="lr", type=float, default=0.0001)
    parser.add_argument("--weight_decay", dest="weight_decay", type=float,
                        default=1e-8)
    parser.add_argument("--val_step_n", dest="val_step_n", type=int, default=None)
    parser.add_argument("--cp_dir", dest="cp_dir", type=str, default=None)
    parser.add_argument("--log_dir", dest="log_dir", type=str, default=None)
    parser.add_argument("--grad_accum", dest="grad_accum", type=int, default=1,
                        help="Loader batches per optimizer step (their "
                             "gradients' mean)")
    parser.add_argument("--async_ckpt", action="store_true", default=False,
                        help="Write epoch checkpoints on a background thread")
    parser.add_argument("--resume", action="store_true", default=False,
                        help="Resume the train state (model, optimizer, "
                             "scheduler, step) from cp_dir/last_state.pth, at "
                             "the data-schedule position of last_state.sched.json")
    parser.add_argument("--data_seed", dest="data_seed", type=int, default=0,
                        help="Seed of the train shuffle and augmentation; each "
                             "epoch's order derives from (seed, epoch). -1: "
                             "unseeded (no exact resume)")
    parser.add_argument("--uint8_inputs", type=int, default=None,
                        help="Train frames as uint8 (1) or float32 (0); default: "
                             "uint8 without augmentation, float32 with it")
    parser.add_argument("--tail", type=str, default=None,
                        choices=("exact", "pad"),
                        help="Last train batch: 'exact' or 'pad', one step "
                             "on one device: the true smaller batch (the JAX "
                             "package's masked step on a padded tail computes "
                             "exactly the step on its real rows)")
    parser.add_argument("--rec_loss", type=str, default="MSE")
    parser.add_argument("--uv_loss", type=str, default="MSE")
    parser.add_argument("--seg_loss", type=str, default="CE")
    parser.add_argument("--reproj_loss", type=str, default=None)
    parser.add_argument("--consist_loss", type=str, default=None)
    parser.add_argument("--consist_start_iter", type=int, default=0)
    parser.add_argument("--seg_lambda", type=float, default=2.0)
    parser.add_argument("--rec_lambda", type=float, default=2.0)
    parser.add_argument("--uv_lambda", type=float, default=2.0)
    parser.add_argument("--reproj_lambda", type=float, default=8.0)
    parser.add_argument("--consist_lambda", type=float, default=1.0)
    parser.add_argument("--weight_semantics", type=str, default="ref",
                        choices=("ref", "sample"))
    return parser


def get_training_args(argv=None):
    """Training arguments (the JAX package's ``get_training_args``; the
    multi-device ones are accepted and refused by the CLI)."""
    return _training_parser().parse_args(argv)


def get_test_args(argv=None):
    """Checkpoint-sweep test arguments (the JAX package's
    ``get_test_args``): the training arguments plus these."""
    parser = _training_parser()
    parser.description = "Test"
    parser.add_argument("--test_epochs", dest="test_epochs", type=str, default=None,
                        help="List of epochs to test, e.g. 1,2,5")
    parser.add_argument("--metric_img_size", "-mis", dest="metric_img_size",
                        default=(640, 360), help="Metric image size")
    parser.add_argument("--fold_bn", type=int, default=1,
                        help="Fold BatchNorm into conv weights at load "
                             "(inference-only; 0 disables)")
    return parser.parse_args(argv)


def get_serving_args(argv=None):
    """Online-serving arguments (the JAX package's ``get_serving_args``):
    the base parser's model, geometry and device flags plus these."""
    parser = _base_parser()
    parser.description = "Serve"
    parser.add_argument("--http_host", type=str, default="127.0.0.1",
                        help="Bind address (0.0.0.0 to expose)")
    parser.add_argument("--port", type=int, default=8800,
                        help="HTTP port (0 = ephemeral, printed at start)")
    parser.add_argument("--req_outputs", type=str, default="theta,poi,consistency",
                        help="Outputs computed per request (same names as "
                             "predict; segm_mask/warp_mask return base64 PNGs)")
    parser.add_argument("--max_batch", type=int, default=32,
                        help="Dynamic batcher cap (the throughput bucket)")
    parser.add_argument("--max_delay_ms", type=float, default=8.0,
                        help="Max coalescing wait after the first queued "
                             "request before dispatch")
    parser.add_argument("--buckets", type=str, default=None,
                        help="Comma list of batch sizes (default: powers of 2 "
                             "up to max_batch)")
    parser.add_argument("--channel_order", type=str, default="bgr",
                        choices=("bgr", "rgb"),
                        help="Channel order frames are fed to the model in "
                             "(bgr = the video source's)")
    parser.add_argument("--serving_artifact", type=str, default=None,
                        help="Accepted so the JAX command lines parse; refused "
                             "(ROADMAP.md queue 1 item 12)")
    parser.add_argument("--no_warmup", action="store_true",
                        help="Skip running every batch bucket at startup")
    parser.add_argument("--fold_bn", type=int, default=1,
                        help="Fold BatchNorm into conv weights at load "
                             "(inference-only; 0 disables)")
    return parser.parse_args(argv)


def replace_args(args, conf, ignore_keys=None):
    """Overlay YAML values onto parsed args, skipping ``ignore_keys``."""
    if args is None or conf is None:
        raise ValueError("replace_args needs parsed args and a config")
    ignore_keys = ignore_keys or []
    for k in vars(args).keys():
        if k not in ignore_keys and k in conf:
            setattr(args, k, conf[k])
    return args
