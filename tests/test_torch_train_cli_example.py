"""The port's train CLI on ``conf/train_reconstructor.yaml.example`` (CPU).

The example conf, with only its paths and sizes changed (and ``device:
cpu``), runs through the port's CLI with augmentation, RRMSE and focal
losses and TensorBoard at ``log_dir`` (with ``--viz``); the event file
holds the JAX train loop's scalar names (``train/loop.py`` of the JAX
package), the weight and gradient histograms of the validation step and
its image panel.  Without tensorboard the loop logs the JAX line and goes
on.  The torchvision warm start: a variant name is refused as a download,
and a local torchvision-style ``.pth`` warm-starts ``resnet_reg`` exactly
as the JAX CLI does (its ``main``, run for 0 epochs).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "conf", "train_reconstructor.yaml.example")
W, H = 64, 36
# every scalar the JAX train_net writes (its UV scalar only with unet_uv)
JAX_SCALARS = {"Loss/train", "Loss/train seg", "Loss/train rec", "Loss/train reproj",
               "Loss/train consistency", "learning_rate", "Loss/test", "Loss/test_seg",
               "Loss/test_rec", "Loss/test_uv", "Loss/test_reproj", "Loss/test_consist"}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from sports_field_homography_tpu_torch.data.synthetic import write_synthetic_dataset

    root = tmp_path_factory.mktemp("example_set")
    write_synthetic_dataset(str(root), 7, 2, os.path.join(REPO, "assets",
                                                          "mask_ncaa_v4_nc4_m_onehot.png"),
                            os.path.join(REPO, "assets", "template_ncaa_v4_points.json"),
                            size=(W, H), seed=5)
    return root


def _example_conf(synth, tmp_path, **extra):
    """The example conf with its paths and sizes changed."""
    with open(EXAMPLE) as f:
        conf = yaml.safe_load(f)
    conf.update(img_dir=str(synth / "frames"), mask_dir=str(synth / "masks"),
                anno_dir=str(synth / "anno"), val_names=["val_game"],
                cp_dir=str(tmp_path / "cp" / "example") + "/",
                log_dir=str(tmp_path / "runs" / "example"), court_size=[W, H],
                target_size=[W, H], unet_size=[W, H], warp_size=[W, H], batchsize=3,
                epochs=1, device="cpu", **extra)
    path = tmp_path / "conf.yaml"
    path.write_text(yaml.safe_dump(conf))
    return str(path), conf


def test_example_conf_trains_with_tensorboard(synth, tmp_path):
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from sports_field_homography_tpu_torch.cli import train as train_cli

    path, conf = _example_conf(synth, tmp_path, viz=True)
    assert conf["aug"]["apperance"]["jitter"] and conf["reproj_loss"] == "RRMSE"
    assert conf["seg_loss"] == conf["consist_loss"] == "focal"
    hist = train_cli.main(["-c", path], num_data_workers=2)
    # 7 frames at batch 3: 3, 3 and the true tail of 1; validation after step 3
    assert len(hist["steps"]) == 3 and len(hist["validations"]) == 1
    for step in hist["steps"]:
        assert all(np.isfinite(v) for v in step.values())
        assert step["Cons_loss"] == 0.0        # consist_start_iter 25000: gated
    assert sorted(os.listdir(conf["cp_dir"])) == ["CP_epoch1.pth", "conf.yaml"]
    events = os.listdir(conf["log_dir"])
    assert len(events) == 1 and events[0].startswith("events.out.tfevents")
    acc = EventAccumulator(os.path.join(conf["log_dir"], events[0]),
                           size_guidance={"histograms": 0, "scalars": 0})
    acc.Reload()
    assert set(acc.Tags()["scalars"]) == JAX_SCALARS
    assert [e.step for e in acc.Scalars("Loss/train")] == [1, 2, 3]
    hists = acc.Tags()["histograms"]
    assert "weights/inc.double_conv.0.weight" in hists
    assert "grads/resnet_reg.reg.weight" in hists
    assert acc.Tags()["images"] == ["output"]        # --viz: the validation panel


def test_missing_tensorboard_disables_logging(monkeypatch, caplog):
    import logging

    from sports_field_homography_tpu_torch.train.loop import _summary_writer

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logger = logging.getLogger("tb_test")
    with caplog.at_level(logging.INFO, logger="tb_test"):
        assert _summary_writer("runs/x", logger) is None
    assert "TB logging disabled" in caplog.text
    assert _summary_writer(None, logger) is None


@pytest.mark.parametrize("source", ["resnet34", "https://download.pytorch.org/models/x.pth"])
def test_named_warm_start_is_refused_as_a_download(tmp_path, source):
    from sports_field_homography_tpu_torch.cli import train as train_cli

    with pytest.raises(NotImplementedError, match="download"):
        train_cli.main(["--img_dir", "f", "--mask_dir", "m", "--anno_dir", "a", "--cp_dir",
                        str(tmp_path), "--device", "cpu", "--resnet_pretrained", source])


def test_torchvision_warm_start_matches_jax(synth, tmp_path):
    """A torchvision-style resnet18 ``state_dict`` (``conv1``, ``bn1``,
    ``layerN.i.*``, ``fc``) as a local file: the JAX CLI merges it into its
    initial variables; the port's ``warm_start_resnet`` on the same initial
    weights gives the same ``state_dict``, tensor for tensor."""
    from sports_field_homography_tpu.cli import train as jax_train_cli
    from sports_field_homography_tpu.cli.engine import build_model as jax_build_model
    from sports_field_homography_tpu.utils.config import get_training_args as jax_args
    from sports_field_homography_tpu_torch.cli.train import warm_start_resnet
    from sports_field_homography_tpu_torch.compat.jax_params import state_dict_from_jax
    from sports_field_homography_tpu_torch.models import Reconstructor, ReconstructorConfig
    from sports_field_homography_tpu_torch.models.resnet import ResNetSTN, resnet_models

    torch.manual_seed(0)
    tv = ResNetSTN(in_channels=3, **resnet_models["resnet18"]).state_dict()
    tv = {("conv1" + k[len("conv0"):] if k.startswith("conv0") else k): v.clone() + 0.5
          for k, v in tv.items() if not k.startswith("reg.")}
    tv["fc.weight"], tv["fc.bias"] = torch.randn(1000, 512), torch.randn(1000)
    pth = tmp_path / "resnet18_tv.pth"
    torch.save(tv, pth)

    conf = dict(img_dir=str(synth / "frames"), mask_dir=str(synth / "masks"),
                anno_dir=str(synth / "anno"), anno_keys=["poi"], val_names=["val_game"],
                court_img=os.path.join(REPO, "assets", "mask_ncaa_v4_nc4_m_onehot.png"),
                court_poi=os.path.join(REPO, "assets", "template_ncaa_v4_points.json"),
                court_size=[W, H], target_size=[W, H], unet_size=[W, H], warp_size=[W, H],
                resnet_name="resnet18", resnet_input="img+mask", batchsize=3, epochs=0,
                compute_dtype="float32", cp_dir=str(tmp_path / "jax_cp") + "/",
                resnet_pretrained=str(pth))
    conf_path = tmp_path / "jax_conf.yaml"
    conf_path.write_text(json.dumps(conf))
    state = jax_train_cli.main(["-c", str(conf_path)])
    want = state_dict_from_jax({"params": state["params"],
                                "batch_stats": state["batch_stats"]})

    args = jax_args(argv=["-c", str(conf_path)])
    for k, v in conf.items():
        setattr(args, k, v)
    initial = jax_build_model(args, load=None, warp_with_nearest=False).variables
    model = Reconstructor(ReconstructorConfig(
        target_size=(W, H), unet_size=(W, H), warp_size=(W, H), resnet_name="resnet18"))
    model.load_state_dict(state_dict_from_jax(initial), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}

    import logging
    warm_start_resnet(model, str(pth), logging.getLogger("warm_start_test"))
    got = model.state_dict()
    assert set(got) == set(want)
    loaded = 0
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(v, want[k]), k
        if not torch.equal(v, before[k]):
            loaded += 1
            assert torch.equal(v, tv[k[len("resnet_reg."):]]), k
    # every resnet_reg tensor but the stem conv (conv1) and the head (fc)
    assert loaded == sum(1 for k in tv if not k.startswith(("conv1.", "fc."))
                         and not k.endswith("num_batches_tracked"))
    assert torch.equal(got["resnet_reg.conv0.weight"], before["resnet_reg.conv0.weight"])
