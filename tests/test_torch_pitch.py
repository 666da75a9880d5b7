"""The soccer-pitch variant (BASELINE config #5): the port against the JAX
package on the CPU (float32, 64x36, resnet18).

The pitch set is built as ``tests/test_pitch_pipeline.py`` builds it, by
the JAX package's ``scripts/make_synthetic_dataset.py`` from the RGBA
class-colour mask ``assets/pitch_mask_nc4_hd.png`` and the 33 points of
``assets/template_pitch_points.json``.  Held to JAX:

* the port's conversion of the colour mask (``data/synthetic.py``, on
  ``prep/preparation.MASK_CLASS_MAPPINGS``) equals the template the JAX
  script writes, pixel for pixel;
* the horizontal flip with ``assets/pitch-poi-flip-mapping.json`` equals
  JAX's on frames, masks and points, and one train step on the flipped
  pitch batch (focal / MSE / RRMSE / focal, RMSprop) meets
  ``tests/test_torch_train_step.py``'s bounds: losses rtol 2e-3 / atol
  1e-4 (consistency 1e-2 / 1e-3), every gradient within 2e-2 rel-L2 plus
  twice this batch's rounding floor.  The floor is how far JAX's own
  gradient moves when its weights move by 6e-8 relative, measured here
  with the same compiled step: on this batch the ResNet's last block
  moves 3.1e-2 that way (the port's own, 2e-4), as far as the port lies
  from JAX, so the 2e-2 alone would measure JAX's rounding, not the port;
* the port's predict CLI against the JAX CLI from the same weights on the
  validation frames: theta 2e-4, points 5e-4, score 1e-3.

The port's train CLI also runs one epoch on the set with the flip map,
and its checkpoint predicts 33 finite points a frame.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from sports_field_homography_tpu.cli.predict import process as jax_process
from sports_field_homography_tpu.compat.torch_export import save_torch_checkpoint
from sports_field_homography_tpu.data.assets import open_court_poi as jax_poi
from sports_field_homography_tpu.data.assets import open_court_template as jax_template
from sports_field_homography_tpu.data.augmentation import AugmentationPipeline as JaxAug
from sports_field_homography_tpu.models import Reconstructor as JaxReconstructor
from sports_field_homography_tpu.models import ReconstructorConfig as JaxConfig
from sports_field_homography_tpu.ops.interval_warp import build_interval_table
from sports_field_homography_tpu.train.loop import LossConfig as JaxLossConfig
from sports_field_homography_tpu.train.loop import init_train_state, make_train_step
from sports_field_homography_tpu.train.optim import make_optimizer as jax_optimizer
from sports_field_homography_tpu.utils.checkpoint import save_checkpoint
from sports_field_homography_tpu_torch.cli import train as port_train
from sports_field_homography_tpu_torch.cli.predict import process as port_process
from sports_field_homography_tpu_torch.compat.jax_params import state_dict_from_jax
from sports_field_homography_tpu_torch.data.assets import open_court_template
from sports_field_homography_tpu_torch.data.augmentation import AugmentationPipeline
from sports_field_homography_tpu_torch.data.png import read_png
from sports_field_homography_tpu_torch.data.synthetic import (court_labels_from_colors,
                                                              label_template)
from sports_field_homography_tpu_torch.models import Reconstructor, ReconstructorConfig
from sports_field_homography_tpu_torch.train.loop import LossConfig, train_step
from sports_field_homography_tpu_torch.train.optim import make_optimizer
from test_torch_predict_full import near_identity_variables
from test_torch_train_step import _BIAS_BEFORE_BN, _rel_l2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PITCH_IMG = os.path.join(REPO, "assets", "pitch_mask_nc4_hd.png")
PITCH_POI = os.path.join(REPO, "assets", "template_pitch_points.json")
FLIP_MAP = os.path.join(REPO, "assets", "pitch-poi-flip-mapping.json")
W, H, B = 64, 36, 3
LR, WD = 1e-4, 1e-6
LOSSES = dict(seg_loss="focal", rec_loss="MSE", reproj_loss="RRMSE",
              consist_loss="focal", seg_lambda=1.0, rec_lambda=1.0,
              reproj_lambda=8.0, consist_lambda=1.0, consist_start_iter=0,
              batch_size=B)
AUG = {"geometric": {"hflip": 1.0, "poi_flip_map": FLIP_MAP}}


@pytest.fixture(scope="module")
def pitch_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("pitch")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts/make_synthetic_dataset.py"),
         "--dst", str(root / "set"), "--n", "16", "--val_frac", "0.25",
         "--size", str(W), str(H), "--court_img", PITCH_IMG, "--court_poi", PITCH_POI],
        check=True, cwd=REPO, capture_output=True)
    return root


def test_converted_template_equals_the_jax_scripts(pitch_set, tmp_path):
    want = np.array(Image.open(pitch_set / "set" / "court_template_onehot.png"))
    labels, converted = court_labels_from_colors(PITCH_IMG, 4)
    assert converted and labels.dtype == np.uint8
    np.testing.assert_array_equal(labels, want)
    path = label_template(PITCH_IMG, 4, str(tmp_path))
    assert path == str(tmp_path / "court_template_onehot.png")
    np.testing.assert_array_equal(read_png(path), want)
    assert set(np.unique(want)) == {0, 1, 2, 3}
    # a label-coded template is taken as it is
    ncaa = os.path.join(REPO, "assets", "mask_ncaa_v4_nc4_m_onehot.png")
    assert label_template(ncaa, 4, str(tmp_path / "x")) == ncaa
    assert not (tmp_path / "x").exists()


def _samples(root, game, names):
    frames, masks, pois = [], [], []
    for n in names:
        frames.append(np.array(Image.open(root / "set" / "frames" / game / f"{n}.png")))
        masks.append(np.array(Image.open(root / "set" / "masks" / game / f"{n}.png")))
        pois.append(np.asarray(json.load(open(root / "set" / "anno" / game / f"{n}.json"))["poi"]))
    return np.stack(frames), np.stack(masks), np.stack(pois)


@pytest.fixture(scope="module")
def flipped_batch(pitch_set):
    """Three training samples through the hflip with the pitch's map, on
    both pipelines (which must agree), as one batch."""
    frames, masks, pois = _samples(pitch_set, "train_game", [f"{i:06d}" for i in range(B)])
    port_aug, jax_aug = AugmentationPipeline(AUG, (W, H)), JaxAug(AUG, (W, H))
    out = []
    for i in range(B):
        args = (frames[i].astype(np.float32) / 255.0, masks[i].astype(np.int64), None,
                pois[i][:, :2].copy(), pois[i][:, 2].copy(), 100 + i)
        got, want = port_aug(*args), jax_aug(*args)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, w)
        out.append(got)
    assert not np.array_equal(out[0][3], pois[0][:, :2])           # the points moved
    nz = np.stack([o[4] for o in out]).astype(np.float32)
    rng = np.random.RandomState(7)
    return {"image": np.stack([o[0] for o in out]).astype(np.float32),
            "mask": np.stack([o[1] for o in out]).astype(np.int64),
            "weight": (0.5 + 0.5 * rng.rand(B, 1)).astype(np.float32),
            "poi": np.stack([o[3] for o in out]).astype(np.float32), "nonzeros": nz,
            "num_nonzero": np.maximum(nz.sum(1), 1.0).astype(np.float32)}


def test_one_train_step_on_the_flipped_pitch_batch(pitch_set, flipped_batch):
    tmpl = str(pitch_set / "set" / "court_template_onehot.png")
    cfg = JaxConfig(target_size=(W, H), unet_size=(W, H), warp_size=(W, H),
                    resnet_name="resnet18", resnet_input="img+mask")
    model = JaxReconstructor(cfg)
    court = jax_template(tmpl, 4, size=(W, H))
    poi = jax_poi(PITCH_POI, 1)
    assert poi.shape == (1, 33, 2)
    variables = jax.device_get(jax.jit(lambda: model.init(
        jax.random.PRNGKey(5), jnp.zeros((1, H, W, 3)), court, poi, train=False))())
    reg = variables["params"]["resnet_reg"]["reg"]
    reg["kernel"] = (np.random.default_rng(5).standard_normal(reg["kernel"].shape)
                     * 0.02).astype(np.float32)
    optimizer = jax_optimizer("RMSprop", LR, WD, grad_clip_value=0.1)
    step = jax.jit(make_train_step(model, optimizer, JaxLossConfig(**LOSSES), with_grads=True))
    rng = np.random.default_rng(2)
    nudged = jax.tree_util.tree_map(   # the same weights, 6e-8 relative apart
        lambda a: (a * (1 + 6e-8 * rng.standard_normal(a.shape))).astype(a.dtype)
        if a.dtype == np.float32 else a, variables)
    out = []
    for v in (variables, nudged):
        state = init_train_state(v, optimizer)
        state["step"] = jnp.asarray(1, jnp.int32)
        out.append(jax.device_get(step(state, flipped_batch, jnp.asarray(court),
                                       jnp.asarray(poi), build_interval_table(court))))
    (_, logs_j, grads_j), (_, _, grads_nudged) = out

    port = Reconstructor(ReconstructorConfig(target_size=(W, H), unet_size=(W, H),
                                             warp_size=(W, H), resnet_name="resnet18",
                                             resnet_input="img+mask"))
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    court_t = torch.from_numpy(open_court_template(tmpl, 4, size=(W, H))).float() / 4
    opt = make_optimizer("RMSprop", port.parameters(), LR, WD)
    tb = {k: torch.from_numpy(v) for k, v in flipped_batch.items()}
    logs, grads = train_step(port, opt, tb, 1, court_t, torch.from_numpy(poi[0]),
                             LossConfig(**LOSSES), return_grads=True)
    for k in ("Seg_loss", "Rec_loss", "Reproj_loss", "Tot_loss", "Cons_loss"):
        tol = dict(rtol=1e-2, atol=1e-3) if k == "Cons_loss" else dict(rtol=2e-3, atol=1e-4)
        np.testing.assert_allclose(float(logs[k]), float(logs_j[k]), err_msg=k, **tol)
    assert float(logs["Reproj_loss"]) > 0 and float(logs["Cons_loss"]) > 0
    want = state_dict_from_jax({"params": grads_j})
    nudged_g = state_dict_from_jax({"params": grads_nudged})
    checked, worst = 0, (0.0, 0.0, "")
    for name, g in grads.items():
        ref = want[name].numpy()
        if _BIAS_BEFORE_BN.search(name):
            w = want[name.replace(".bias", ".weight")].numpy()
            for side in (ref, g.numpy()):
                assert np.linalg.norm(side) < 1e-3 * np.linalg.norm(w), name
            continue
        if np.linalg.norm(ref) < 1e-6:
            continue
        rel, floor = _rel_l2(ref, g.numpy()), _rel_l2(ref, nudged_g[name].numpy())
        assert rel < 2e-2 + 2 * floor, (name, rel, floor)
        worst = max(worst, (rel, floor, name))
        checked += 1
    assert checked > 50
    print(f"\npitch step: worst gradient rel-L2 {worst[0]:.3e} ({worst[2]}), JAX's own "
          f"rounding floor there {worst[1]:.3e}, over {checked} leaves")


def _conf(tmpl):
    return {"target_size": [W, H], "unet_size": [W, H], "warp_size": [W, H],
            "court_size": [W, H], "mask_classes": 4, "resnet_name": "resnet18",
            "resnet_input": "img+mask", "use_unet": True, "use_resnet": True,
            "court_img": tmpl, "court_poi": PITCH_POI}


def test_predict_cli_matches_jax_on_the_pitch(pitch_set, tmp_path):
    tmpl = str(pitch_set / "set" / "court_template_onehot.png")
    cp_dir = tmp_path / "ckpt" / "pitch_v1"
    cp_dir.mkdir(parents=True)
    with open(cp_dir / "conf.yaml", "w") as f:
        json.dump(_conf(tmpl), f)
    variables = near_identity_variables(1)
    save_checkpoint(str(cp_dir / "CP_epoch1.msgpack"), variables)
    save_torch_checkpoint(str(cp_dir / "CP_epoch1.pth"), variables)
    frames = str(pitch_set / "set" / "frames" / "val_game")

    def argv(ext, dst):
        return ["--img_dir", frames, "--load", str(cp_dir / f"CP_epoch1.{ext}"),
                "--dst_dir", str(dst), "--req_outputs", "theta,poi,consistency",
                "--batchsize", "3", "--compute_dtype", "float32",
                "--court_img", tmpl, "--court_poi", PITCH_POI]

    jax_process(argv("msgpack", tmp_path / "jax"))
    port_process(argv("pth", tmp_path / "port") + ["--device", "cpu"])
    want = json.load(open(tmp_path / "jax" / "val_game_court.json"))
    got = json.load(open(tmp_path / "port" / "val_game_court.json"))
    assert set(got) == set(want) and len(got) == 5                # 4 frames + model
    for name in (k for k in want if k != "model"):
        np.testing.assert_allclose(got[name]["theta"], want[name]["theta"], rtol=0, atol=2e-4)
        assert np.asarray(got[name]["poi"]).shape[-2:] == (33, 2)
        np.testing.assert_allclose(got[name]["poi"], want[name]["poi"], rtol=0, atol=5e-4)
        assert abs(got[name]["score"] - want[name]["score"]) <= 1e-3 + 1e-6


def test_port_train_cli_on_the_pitch_with_its_flip_map(pitch_set, tmp_path):
    tmpl = str(pitch_set / "set" / "court_template_onehot.png")
    data = pitch_set / "set"
    conf = dict(_conf(tmpl), img_dir=str(data / "frames"), mask_dir=str(data / "masks"),
                anno_dir=str(data / "anno"), anno_keys=["poi", "reproj_mse"],
                val_names=["val_game"], epochs=1, batchsize=B, opt="RMSprop", lr=1e-4,
                weight_decay=1e-6, seg_loss="focal", rec_loss="MSE", reproj_loss="RRMSE",
                consist_loss="focal", consist_start_iter=0, cp_dir=str(tmp_path / "cp") + "/",
                aug={"geometric": {"hflip": 0.5, "poi_flip_map": FLIP_MAP}},
                compute_dtype="float32", device="cpu")
    path = tmp_path / "conf.json"
    path.write_text(json.dumps(conf))
    hist = port_train.main(["-c", str(path)], num_data_workers=1)
    assert len(hist["steps"]) == 4                                 # 12 frames, batch 3
    assert all(np.isfinite(v) for st in hist["steps"] for v in st.values())
    port_process(["--img_dir", str(data / "frames" / "val_game"), "--load",
                  str(tmp_path / "cp" / "CP_epoch1.pth"), "--dst_dir", str(tmp_path / "pred"),
                  "--req_outputs", "theta,poi,consistency", "--court_img", tmpl,
                  "--court_poi", PITCH_POI, "--device", "cpu", "--compute_dtype", "float32"])
    out = json.load(open(tmp_path / "pred" / "val_game_court.json"))
    out.pop("model")
    assert len(out) == 4
    for rec in out.values():
        assert np.isfinite(rec["theta"]).all() and np.isfinite(rec["score"])
        assert np.asarray(rec["poi"]).shape[-2:] == (33, 2) and np.isfinite(rec["poi"]).all()
