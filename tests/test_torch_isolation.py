"""The port stands apart from JAX, reads its assets without Pillow the way
Pillow does, and dispatches its kernels by device."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from PIL import Image

from sports_field_homography_tpu.data.assets import open_court_template as jax_template
from sports_field_homography_tpu_torch.data import image as image_mod
from sports_field_homography_tpu_torch.data.assets import (open_court_template,
                                                           resize_nearest_pil)
from sports_field_homography_tpu_torch.data.png import read_png
from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3
from sports_field_homography_tpu_torch.ops.deconv import deconv2x2
from sports_field_homography_tpu_torch.ops.warp import warp_nearest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COURT = f"{REPO}/assets/mask_ncaa_v4_nc4_m_onehot.png"


def test_port_imports_no_jax():
    """Every module of the port imports in a fresh interpreter, and none
    of them pulls in jax (the JAX package's __init__ imports jax)."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.path.insert(0, {REPO!r})
        import sports_field_homography_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        assert len(names) >= 51, names
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "msgpack")
                     or m.startswith("sports_field_homography_tpu."))
        assert not bad, bad
        print("ok", len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_serving_modules_import_no_jax():
    """The serving artifact's modules (the operator namespace, the export
    and load functions, the export CLI, the server) import in a fresh
    interpreter without jax or the JAX package, and loading the operators
    registers the predict path's five ``sfh`` operators, with no model code."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import torch
        from sports_field_homography_tpu_torch.ops import library
        library.load_operators()
        ops = sorted(n for n in ("warp_nearest", "conv3x3", "conv3x3_stats", "deconv2x2",
                                 "bn_relu_norm") if hasattr(torch.ops.sfh, n))
        assert len(ops) == 5, ops
        assert not any(m.startswith("sports_field_homography_tpu_torch.models")
                       for m in sys.modules)
        import sports_field_homography_tpu_torch.compat.serving
        import sports_field_homography_tpu_torch.cli.export_serving
        import sports_field_homography_tpu_torch.serve.server
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "msgpack")
                     or m.startswith("sports_field_homography_tpu."))
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_train_cli_runs_the_card_machines_way(tmp_path):
    """The train CLI as the GPU machine runs it, in a fresh interpreter
    where Pillow, cv2, PyYAML and tensorboard do not import: a JSON conf
    with the example conf's augmentation (jitter, blur, hflip) and
    ``log_dir`` trains (TensorBoard disabled, as logged), while ``scale``
    and UV masks are refused before the model is built; jax never loads."""
    code = textwrap.dedent(f"""
        import json, sys
        for name in ("PIL", "cv2", "yaml", "tensorboard"):
            sys.modules[name] = None
        sys.path.insert(0, {REPO!r})
        from sports_field_homography_tpu_torch.cli import engine, train
        from sports_field_homography_tpu_torch.data.synthetic import write_synthetic_dataset

        root = {str(tmp_path)!r}
        court = {COURT!r}
        poi = court.replace("mask_ncaa_v4_nc4_m_onehot.png", "template_ncaa_v4_points.json")
        write_synthetic_dataset(root + "/set", 4, 1, court, poi, size=(64, 36), seed=0)
        aug = {{"apperance": {{"jitter": {{"brightness": 0.35, "hue": 0.25}}, "blur": 5}},
               "geometric": {{"hflip": 0.5}}}}
        conf = dict(img_dir=root + "/set/frames", mask_dir=root + "/set/masks",
                    anno_dir=root + "/set/anno", anno_keys=["poi"], val_names=["val_game"],
                    court_img=court, court_poi=poi, court_size=[64, 36], target_size=[64, 36],
                    unet_size=[64, 36], warp_size=[64, 36], resnet_name="resnet18",
                    batchsize=2, epochs=1, cp_dir=root + "/cp/", log_dir=root + "/runs",
                    reproj_loss="RRMSE", aug=aug, compute_dtype="float32", device="cpu")

        def run(**extra):
            path = root + "/conf.json"
            with open(path, "w") as f:
                json.dump(dict(conf, **extra), f)
            return train.main(["-c", path], num_data_workers=1)

        hist = run()
        assert len(hist["steps"]) == 2, hist

        def refuse(**extra):
            built = []
            engine_build, train.build_model = train.build_model, built.append
            try:
                run(**extra)
            except RuntimeError as e:
                assert not built, "refused after the model was built"
                return str(e)
            finally:
                train.build_model = engine_build
            raise AssertionError("not refused")

        assert "Pillow" in refuse(aug={{"geometric": {{"scale": [0.8, 1.0]}}}})
        assert "cv2" in refuse(unet_uv=True)
        bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.rstrip().endswith("ok")
    assert "TB logging disabled" in out.stdout


def test_png_reader_matches_pillow_on_court_asset():
    got = read_png(COURT)
    want = np.array(Image.open(COURT))
    assert got.dtype == np.uint8 and got.shape == want.shape == (1819, 3421)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,optimize", [("RGB", False), ("RGB", True),
                                           ("L", True), ("RGBA", False)])
def test_png_reader_matches_pillow_on_filtered_frames(tmp_path, mode, optimize):
    """Pillow's encoder picks a filter per row (Sub, Up, Average, Paeth)."""
    rng = np.random.default_rng(0)
    ch = {"RGB": 3, "L": 1, "RGBA": 4}[mode]
    smooth = np.cumsum(rng.integers(0, 3, (37, 53, ch)), axis=1) % 256
    noise = rng.integers(0, 256, (37, 53, ch))
    arr = np.where(np.arange(37)[:, None, None] % 3 == 0, noise, smooth).astype(np.uint8)
    arr = arr[..., 0] if ch == 1 else arr
    path = tmp_path / "f.png"
    Image.fromarray(arr, mode).save(path, optimize=optimize)
    np.testing.assert_array_equal(read_png(str(path)), np.array(Image.open(path)))


@pytest.mark.parametrize("size", [(1280, 720), (640, 360), (128, 72), (4000, 2000)])
def test_template_resize_matches_jax(size):
    """The numpy NEAREST rule equals Pillow's, through the JAX loader."""
    want = jax_template(COURT, 4, size=size)[0, :, :, 0]
    got = open_court_template(COURT, 4, size=size)
    assert got.shape == (size[1], size[0])
    np.testing.assert_array_equal(got.astype(np.float32) / 4.0, want)


def test_template_loads_without_pillow(monkeypatch):
    monkeypatch.setattr(image_mod, "have_pillow", lambda: False)
    got = open_court_template(COURT, 4, size=(640, 360))
    want = np.array(Image.open(COURT).resize((640, 360), Image.NEAREST))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError, match="needs Pillow"):
        image_mod.read_image(COURT, size=(640, 360))


def test_resize_nearest_pil_rgb():
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 256, (31, 47, 3), dtype=np.uint8)
    for size in ((20, 11), (94, 62), (47, 31)):
        want = np.array(Image.fromarray(arr).resize(size, Image.NEAREST))
        np.testing.assert_array_equal(resize_nearest_pil(arr, size), want)


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the wrappers run their plain versions: no launch counted."""
    counts = lambda: (warp_nearest.launches, conv3x3.launches, conv3x3.tc_launches,  # noqa: E731
                      deconv2x2.launches)
    before = counts()
    x = torch.rand(1, 4, 4, 64)
    conv3x3(x, torch.rand(3, 3, 64, 64))
    conv3x3(x.bfloat16(), torch.rand(3, 3, 64, 64))      # the tensor-core shape, on the CPU
    deconv2x2(x, torch.rand(64, 2, 2, 4), torch.rand(4))
    warp_nearest(torch.zeros(4, 4, dtype=torch.uint8), torch.eye(3)[None], (4, 4),
                 torch.arange(256, dtype=torch.float32))
    assert counts() == before


def test_wrappers_refuse_other_devices():
    """Neither a mix of devices nor a device without a kernel falls back."""
    x = torch.rand(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv3x3(x, torch.rand(3, 3, 8, 8, device="meta"))
    with pytest.raises(ValueError, match="different devices"):
        deconv2x2(torch.rand(1, 4, 4, 8), torch.rand(8, 2, 2, 4, device="meta"),
                  torch.rand(4))


def png_with_filters(img, ftypes):
    """(H, W, 3) uint8 as an RGB PNG's bytes, row r with filter
    ``ftypes[r]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), per the PNG
    specification."""
    import struct
    import zlib

    h, w, c = img.shape
    x = img.astype(np.int32).reshape(h, w * c)
    up = np.vstack([np.zeros((1, w * c), np.int32), x[:-1]])
    left = np.hstack([np.zeros((h, c), np.int32), x[:, :-c]])
    upleft = np.hstack([np.zeros((h, c), np.int32), up[:, :-c]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = [np.zeros_like(x), left, up, (left + up) // 2, paeth]
    rows = [np.concatenate([[t], (x[r] - preds[t][r]) & 0xFF]).astype(np.uint8)
            for r, t in enumerate(ftypes)]

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return b"".join([b"\x89PNG\r\n\x1a\n",
                     chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
                     chunk(b"IDAT", zlib.compress(np.stack(rows).tobytes())),
                     chunk(b"IEND", b"")])


def _write_png_all_filters(path, img):
    """Encode an (H, W, 3) uint8 image with row filter r % 5 (None, Sub,
    Up, Average, Paeth)."""
    with open(path, "wb") as f:
        f.write(png_with_filters(img, [r % 5 for r in range(img.shape[0])]))


def test_png_reader_every_filter_type(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (23, 19, 3), dtype=np.uint8)
    path = tmp_path / "filters.png"
    _write_png_all_filters(path, img)
    np.testing.assert_array_equal(np.array(Image.open(path)), img)
    np.testing.assert_array_equal(read_png(str(path)), img)
