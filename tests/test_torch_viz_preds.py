"""The prediction-video renderer (``cli/viz_preds.py``): the port against
the JAX package's renderer on the CPU, ``--no_encode`` (no ffmpeg).

The setup is the JAX package's ``tests/test_viz_preds.py`` at 64x36: a
seeded mp4 of 5 frames, a ``{game}_court.json`` whose first frames score
below the threshold (the warp, K1's plain version here) and whose others
take the pickled segmentation masks.  Each rendered PNG equals JAX's byte
for byte, for 4 classes and for 7, whose quotients ``label / 7`` are not
exact in float32 and whose labels both renderers take by truncating the
float32 product of the warped value and the class count.

JAX's renderer jit-compiles its warp, and XLA's compiled coordinate
arithmetic rounds differently from the same function run op by op: on
these inputs 3 of 2304 labels a frame land on the other side of a
half-pixel tie.  The port's warp equals JAX's warp run op by op, label for
label (as K1 equals the JAX warps, ``tests/test_torch_warp.py``).  So the
renders are held byte-equal to JAX's renderer with its warp run op by op,
and against its jitted renderer they may differ only on the pixels where
JAX's two runs of its own warp disagree (< 0.2 %).
"""
import json
import os
import pickle

import numpy as np
import pytest

from sports_field_homography_tpu.cli import viz_preds as jax_viz
from sports_field_homography_tpu_torch.cli import viz_preds as port_viz
from sports_field_homography_tpu_torch.ops.warp import template_value_table

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COURT = os.path.join(REPO, "assets", "mask_ncaa_v4_nc4_m_onehot.png")
W, H, N = 64, 36, 5
THETA = [[[1.2, 0.05, 0.0], [0.0, 1.8, 0.4], [0.0, 0.6, 1.0]]]


def _inputs(root, n_classes):
    video = str(root / "game.mp4")
    wr = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 10, (W, H))
    rng = np.random.RandomState(0)
    for _ in range(N):
        wr.write(rng.randint(0, 255, (H, W, 3), dtype=np.uint8))
    wr.release()
    preds = {str(i).zfill(6): {"score": 0.05 if i < 3 else 0.9,
                               "theta": (np.asarray(THETA) * (1 + 0.02 * i)).tolist()}
             for i in range(N)}
    preds["model"] = "test_model"
    preds_path = str(root / "game_court.json")
    json.dump(preds, open(preds_path, "w"))
    masks_path = str(root / "data.pkl")
    with open(masks_path, "wb") as f:
        for i in range(N):
            _, buf = cv2.imencode(".png", rng.randint(0, n_classes, (H, W), dtype=np.uint8))
            pickle.dump([str(i).zfill(6), buf], f)
    return video, preds_path, masks_path


def _render(fn, root, side, inputs, n_classes, **extra):
    """{file name: PNG bytes} of one renderer's frames."""
    video, preds, masks = inputs
    dst = root / side
    dst.mkdir()
    res = fn(video, preds, str(dst), COURT, masks_path=masks, mask_classes=n_classes,
             out_size=(W, H), score_threshold=0.17, encode_video=False, **extra)
    chunk = dst / "_temp" / "_chunk0"
    assert sorted(os.listdir(chunk)) == [f"{i:06d}.png" for i in range(N)]
    return res, {f: (chunk / f).read_bytes() for f in os.listdir(chunk)}


def _jax_labels_jit_and_eager(i, n_classes):
    """JAX's warp labels of frame i, compiled and op by op."""
    import jax
    import jax.numpy as jnp

    from sports_field_homography_tpu.data.assets import open_court_template
    from sports_field_homography_tpu.geometry.warp import warp_homography

    ci = jnp.asarray(open_court_template(COURT, n_classes, (W, H), 1))
    theta = jnp.asarray(np.asarray(THETA, np.float32) * np.float32(1 + 0.02 * i))

    def fn(c, t):
        return (warp_homography(c, t, (H, W), mode="nearest")[..., 0] * n_classes
                ).astype(jnp.int32)

    return np.asarray(jax.jit(fn)(ci, theta))[0], np.asarray(fn(ci, theta))[0]


@pytest.mark.parametrize("n_classes", [4, 7])
def test_renders_equal_jax(tmp_path, n_classes, monkeypatch):
    inputs = _inputs(tmp_path, n_classes)
    warped, port = _render(port_viz.vizualize, tmp_path, "port", inputs, n_classes,
                           device="cpu")
    assert warped == 3                                          # frames 0-2 warped
    _, jitted = _render(jax_viz.vizualize, tmp_path, "jax", inputs, n_classes)
    with monkeypatch.context() as m:        # JAX's renderer with its warp run op by op
        m.setattr(jax_viz.jax, "jit", lambda f: f)
        _, eager = _render(jax_viz.vizualize, tmp_path, "jax_eager", inputs, n_classes)
    for name, data in eager.items():
        assert port[name] == data, name
    ties = 0
    for i in range(N):
        name = f"{i:06d}.png"
        a = cv2.imdecode(np.frombuffer(port[name], np.uint8), cv2.IMREAD_COLOR)
        b = cv2.imdecode(np.frombuffer(jitted[name], np.uint8), cv2.IMREAD_COLOR)
        differ = np.any(a != b, axis=-1)
        if i >= 3:                                  # the segmentation masks' frames
            assert not differ.any(), name
            continue
        lab_jit, lab_eager = _jax_labels_jit_and_eager(i, n_classes)
        assert not (differ & (lab_jit == lab_eager)).any(), name
        ties += int((lab_jit != lab_eager).sum())
    assert ties < 2e-3 * 3 * H * W
    assert cv2.imread(str(tmp_path / "port" / "_temp" / "_chunk0" / "000000.png")).shape \
        == (H, W, 3)


def test_seven_classes_need_the_quotient_table():
    """The warp's labels for 7 classes: the float32 quotients truncate back
    to every label, the interval table's values do not (why the renderer
    gives K1 ``quotient_table``, as JAX's renderer warps the float
    template itself)."""
    labels = np.arange(7, dtype=np.uint8)
    quotients = port_viz.quotient_table(7)[:7]
    assert ((quotients * 7).int().numpy() == labels).all()
    want = (np.arange(7, dtype=np.float32) / np.float32(7) * 7).astype(np.int32)
    np.testing.assert_array_equal((quotients * 7).int().numpy(), want)
    interval = template_value_table(labels, 7)[:7]
    assert not ((interval * 7).int().numpy() == labels).all()


def test_cli_main_and_the_ffmpeg_refusal(tmp_path, monkeypatch):
    video, preds, masks = _inputs(tmp_path, 4)
    args = ["--video_path", video, "--preds_path", preds, "--masks_path", masks,
            "--dst_dir", str(tmp_path / "out"), "--field_path", COURT, "--device", "cpu"]
    assert port_viz.get_args(args[:6]).device == "cuda"        # the card by default
    monkeypatch.setattr(port_viz.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="ffmpeg not found on PATH"):
        port_viz.main(args)
    (tmp_path / "out").mkdir()
    # the default threshold 0.17 sends frames 0-2 to the warp; 1280x720 renders
    # are resized to the frame
    assert port_viz.main(args + ["--no_encode"]) == 3
    files = sorted(os.listdir(tmp_path / "out" / "_temp" / "_chunk0"))
    assert files == [f"{i:06d}.png" for i in range(N)]


def test_readers():
    """The prediction reader drops ``model``; the mask reader without a
    stream yields one empty entry per prediction."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "g_court.json")
        json.dump({"model": "m", "000001": {"score": 1.0, "theta": THETA}}, open(path, "w"))
        reader = port_viz.PredictionReader(path)
        assert len(reader) == 1 and [n for n, _ in reader] == ["000001"]
        masks = port_viz.MaskReader(names=["000001"])
        assert list(masks) == [("000001", None)]
        with pytest.raises(AssertionError):
            port_viz.MaskReader()
