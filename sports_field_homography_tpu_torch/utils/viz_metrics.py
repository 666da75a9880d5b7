"""Accuracy-vs-throughput charts from ``test_scores.txt`` logs (port of
``utils/viz_metrics.py``): parses the checkpoint-sweep logs the test CLI
(``cli/test.py``) writes, picks each model's best checkpoint by
reprojection px and renders scatter charts (reprojection px / RMSE /
segmentation CE / reconstruction MSE against imgs/s) and a ranked score
log.  PyYAML and matplotlib (Agg) are imported where they are used.
"""
from __future__ import annotations

import os
from pathlib import PurePath

import numpy as np

__all__ = ["read_log", "parse_model_dir", "make_score_log",
           "vizualize_metrics"]


def read_version(path):
    import yaml

    with open(path, "r") as f:
        data = yaml.safe_load(f)
    return data["version"] if isinstance(data, dict) and "version" in data else "none"


def read_log(test_path, target_dataset=None, max_reproj_px=None):
    """Parse a ``test_scores.txt`` sweep log into checkpoint entries, one
    for each "Starting testing" / "Test scores" pair."""
    import yaml

    checkpoints = []
    with open(test_path, "r") as f:
        data = f.read()
    # duplicate-keys yaml: split documents at logger banners
    data = data.replace("<<< ", "\n---\n")
    for part in yaml.load_all(data, Loader=yaml.Loader):
        if not isinstance(part, dict):
            continue
        if "Test scores" not in part or "Starting testing" not in part:
            continue
        params = part["Starting testing"]
        scores = part["Test scores"]
        num_imgs = int(params["Test size"])
        if target_dataset is not None:
            dataset = PurePath(params["Images dir"]).parts[-2]
            if target_dataset != dataset:
                print("Log dataset does not match the target dataset. "
                      "The log will be skipped!")
                continue
        reproj_px = float(scores["Reprojection px"])
        if max_reproj_px is not None and reproj_px > max_reproj_px:
            continue
        checkpoints.append({
            "epoch": str(params["Model file"]).split("/")[-1],
            "reproj_px": reproj_px,
            "reproj_rmse": float(scores["Reprojection RMSE"]),
            "segm_ce": float(scores["Segmentation CE"]),
            "rec_mse": float(scores["Reconstruction MSE"]),
            "imgs_per_sec": num_imgs / float(scores["Elapsed msec"]) * 1000,
        })
    return checkpoints


def parse_model_dir(model_dir, target_dataset=None, max_reproj_px=None):
    """The best checkpoint (least reprojection px) of one model dir."""
    conf_path = os.path.join(model_dir, "conf.yaml")
    test_path = os.path.join(model_dir, "test_scores.txt")
    if not os.path.isfile(conf_path):
        print("Directory does not contain conf.yaml file and will be skipped!")
        return None
    if not os.path.isfile(test_path):
        print("Directory does not contain test_scores.txt file and will be skipped!")
        return None
    read_version(conf_path)
    checkpoints = read_log(test_path, target_dataset, max_reproj_px)
    return min(checkpoints, key=lambda e: e["reproj_px"], default=None)


def plot_chart(scores, ykey, xkey, ylabel="", xlabel="", legend=True):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.cm as cm
    import matplotlib.pyplot as plt

    color_map = iter(cm.rainbow(np.linspace(0, 1, len(scores))))
    plot_name = xkey + "-vs-" + ykey + ".png"
    plt.figure(figsize=(16, 6), num=plot_name)
    ax = plt.subplot(111)
    ax.grid(True)
    ax.set_ylabel(ylabel)
    ax.set_xlabel(xlabel)
    for i, score in enumerate(scores):
        ax.scatter(score[xkey], score[ykey], color=next(color_map),
                   label=f"{i + 1} {score['name']}")
        ax.text(score[xkey], score[ykey], str(i + 1))
    if legend:
        box = ax.get_position()
        ax.set_position([box.x0, box.y0, box.width * 0.5, box.height])
        ax.legend(loc="center left", bbox_to_anchor=(1, 0.5))
    return plt


def make_score_log(model_scores, score_keys, dst_path=None):
    log = []
    for key in score_keys:
        ranked = sorted(
            (model[key],
             f"{model[key]:.6f} : ({i + 1}) {model['name']} ({model['epoch']})")
            for i, model in enumerate(model_scores))
        log += [f">>>{key}:", *(line for _, line in ranked), ""]
    if dst_path is not None:
        with open(dst_path, "w") as f:
            f.write("".join(line + "\n" for line in log))
    return log


_CHARTS = [
    ("reproj_px", "Reprojection RMSE (pixels)", "imgs_per_sec", "imgs/sec"),
    ("reproj_rmse", "Reprojection RMSE", "imgs_per_sec", "imgs/sec"),
    ("reproj_px", "Reprojection RMSE (pixels)", "segm_ce",
     "Segmentation Cross-Entropy"),
    ("reproj_px", "Reprojection RMSE (pixels)", "rec_mse",
     "Reconstruction MSE"),
]


def vizualize_metrics(src_dir, dst_dir=None, target_dataset=None,
                      max_reproj_px=None, show=False):
    """Best-score charts over all model dirs of ``src_dir``."""
    model_scores = []
    for name in sorted(os.listdir(src_dir)):
        model_dir = os.path.join(src_dir, name)
        if not os.path.isdir(model_dir):
            continue
        print(f"Parsing {model_dir}...")
        score = parse_model_dir(model_dir, target_dataset, max_reproj_px)
        if score is not None:
            model_scores.append(dict(score, name=name))

    if dst_dir is not None:
        os.makedirs(dst_dir, exist_ok=True)

    for xkey, xlabel, ykey, ylabel in _CHARTS:
        plt = plot_chart(model_scores, ykey, xkey, ylabel, xlabel)
        if dst_dir is not None:
            dst_path = os.path.join(dst_dir, f"{xkey}-vs-{ykey}.png")
            plt.savefig(dst_path)
            print(f"Chart has been saved to {dst_path}")
        if show:
            plt.show()
        plt.close()

    if dst_dir is not None:
        log_path = os.path.join(dst_dir, "scores.txt")
        make_score_log(model_scores,
                       ["reproj_px", "reproj_rmse", "segm_ce", "rec_mse",
                        "imgs_per_sec"], log_path)
        print(f"Log has been saved to {log_path}")
    print("All done!")
    return model_scores
