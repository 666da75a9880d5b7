"""The port's serving artifact (``compat/serving.py``, ``cli/export_serving.py``)
and the ``sfh`` operators it is traced through (``ops/library.py``), on the
CPU, where each operator runs its kernel's plain version.

The model is the JAX serving tests' size: 64x36, resnet18 img+mask, with
``near_identity_variables(0)`` (numpy-seeded JAX variables, theta near the
identity) carried across by ``compat/jax_params``, BN folded.  Bounds
against JAX (``docs/PARITY.md``): theta max-abs 2e-4, score 1e-3, poi 5e-4.
Against the port's own live program the artifact is bit-equal: it runs the
same operators on the same weights (bf16 weights only where the program
casts them to bf16 at every use).
"""
import collections
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax

from sports_field_homography_tpu.cli.engine import build_model as jax_build_model
from sports_field_homography_tpu.cli.engine import jit_predict_fn
from sports_field_homography_tpu.compat.serving import export_predict as jax_export_predict
from sports_field_homography_tpu.compat.serving import load_serving as jax_load_serving
from sports_field_homography_tpu.compat.serving import save_serving as jax_save_serving
from sports_field_homography_tpu.utils.checkpoint import save_checkpoint
from sports_field_homography_tpu_torch.cli import export_serving
from sports_field_homography_tpu_torch.cli.engine import build_model, predict_fn
from sports_field_homography_tpu_torch.compat.serving import (export_predict, load_serving,
                                                              save_serving)
from sports_field_homography_tpu_torch.ops import library
from sports_field_homography_tpu_torch.ops.bn_relu import bn_relu_norm
from sports_field_homography_tpu_torch.ops.conv3x3 import conv3x3
from sports_field_homography_tpu_torch.ops.deconv import deconv2x2
from sports_field_homography_tpu_torch.ops.warp import template_value_table, warp_nearest
from sports_field_homography_tpu_torch.utils.config import get_prediction_args
from test_torch_predict_cli import COURT, POI, H, W
from test_torch_predict_full import near_identity_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEEP = ("consist_score", "poi", "theta", "warp_mask")
# the predict path's launches a batch (PERF.md section 6), as chip_smoke.py gates them
PATH_OPS = {"sfh.conv3x3.default": 17, "sfh.deconv2x2.default": 4,
            "sfh.bn_relu_norm.default": 9, "sfh.warp_nearest.default": 1}
TWO_INPUT_K2 = 4


class _Args:
    batchsize = 2
    target_size = unet_size = warp_size = court_size = (W, H)
    mask_classes = 4
    use_unet, unet_bilinear, unet_uv, use_resnet, use_warper = True, False, False, True, True
    resnet_name, resnet_input = "resnet18", "img+mask"
    compute_dtype, device = "float32", "cpu"
    court_img, court_poi = COURT, POI


class _Bf16(_Args):
    compute_dtype = "bfloat16"


def _frames(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, H, W, 3), dtype=np.uint8)


@pytest.fixture
def scratch(tmp_path):
    """``tmp_path``, emptied after the test: an artifact at this size is
    80-330 MB, and pytest keeps the temporary directories of past runs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """``near_identity_variables(0)`` as a JAX ``.msgpack`` with its conf."""
    d = tmp_path_factory.mktemp("serving_ckpt")
    with open(d / "conf.yaml", "w") as f:
        json.dump({"target_size": [W, H], "unet_size": [W, H], "warp_size": [W, H],
                   "court_size": [W, H], "mask_classes": 4, "resnet_name": "resnet18",
                   "resnet_input": "img+mask", "use_unet": True, "use_resnet": True}, f)
    path = str(d / "CP_epoch1.msgpack")
    save_checkpoint(path, near_identity_variables(0))
    yield path
    shutil.rmtree(d, ignore_errors=True)


def _bundle(ckpt, args=_Args):
    return build_model(args, load=ckpt, warp_with_nearest=True, fold_bn=True)


@pytest.fixture(scope="module")
def f32_artifact(ckpt, tmp_path_factory):
    """A fixed-batch (2) f32 artifact of theta, score, poi and the warp mask."""
    bundle = _bundle(ckpt)
    ep, meta = export_predict(bundle, consistency=True, project_poi=True, keep=KEEP,
                              batch_size=2)
    root = tmp_path_factory.mktemp("f32")
    d = str(root / "serving")
    save_serving(d, ep, meta)
    yield bundle, ep, d
    shutil.rmtree(root, ignore_errors=True)


def _assert_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_f32_artifact_bit_equal_to_live(f32_artifact):
    bundle, _, d = f32_artifact
    fn, meta = load_serving(d)
    assert meta["format"] == "torch.export" and meta["platforms"] == ["cpu"]
    assert meta["input"] == {"shape": [2, H, W, 3], "dtype": "uint8", "layout": "NHWC",
                             "poly_batch": False, "poly_batch_max": None,
                             "recommended_batch": 2,
                             "note": "uint8 inputs are normalized (x/255) in-program"}
    assert meta["outputs"] == sorted(KEEP) and meta["weights_dtype"] == "float32"
    assert meta["pjrt_sidecars"] is None
    assert sorted(os.listdir(d)) == ["meta.json", "program.pt2"]
    x = torch.from_numpy(_frames(2, 7))
    with torch.inference_mode():
        got, want = fn(x), predict_fn(bundle, True, KEEP)(x)
    _assert_equal(got, want)
    assert got["warp_mask"].dtype == torch.uint8 and torch.isfinite(got["theta"]).all()
    with pytest.raises(Exception):       # a fixed-batch program takes its batch only
        fn(torch.from_numpy(_frames(3, 7)))


def test_float32_input_artifact(f32_artifact, scratch):
    """``input_dtype="float32"``: the program takes frames already in
    [0, 1] and answers as the uint8 program does on ``frames / 255``."""
    bundle, _, d = f32_artifact
    ep, meta = export_predict(bundle, consistency=True, project_poi=True, keep=KEEP,
                              batch_size=2, input_dtype="float32")
    assert meta["input"]["dtype"] == "float32"
    save_serving(str(scratch / "f32in"), ep, meta)
    fn, _ = load_serving(str(scratch / "f32in"))
    x = torch.from_numpy(_frames(2, 8))
    with torch.inference_mode():
        _assert_equal(fn(x.float() / 255.0), load_serving(d)[0](x))


def test_bf16_weights_bit_equal_to_live(ckpt, scratch):
    """bf16 compute: the conv weights (and the stem's and the 1x1 head's
    bias) are stored in bf16, every BN vector, K2/K3 bias and the STN's f32
    head in f32; the outputs stay bit-equal to the live program, whose
    weights the export leaves untouched."""
    bundle = _bundle(ckpt, _Bf16)
    before = {k: v.clone() for k, v in bundle.model.state_dict().items()}
    keep = ("consist_score", "poi", "theta")
    ep, meta = export_predict(bundle, consistency=True, project_poi=True, keep=keep,
                              batch_size=2)
    assert all(torch.equal(v, before[k]) and v.dtype == before[k].dtype
               for k, v in bundle.model.state_dict().items())
    assert meta["weights_dtype"] == "bfloat16"
    sd = ep.state_dict
    bf16 = {k for k, v in sd.items() if v.dtype == torch.bfloat16}
    assert "model.inc.double_conv.0.weight" in bf16 and "model.inc.double_conv.0.bias" in bf16
    assert "model.outc.conv.weight" in bf16 and "model.resnet_reg.layer1.0.conv1.weight" in bf16
    for k in ("model.inc.double_conv.3.bias", "model.up1.up.bias", "model.resnet_reg.reg.weight",
              "model.resnet_reg.bn1.running_var", "model.inc.double_conv.1.weight"):
        assert sd[k].dtype == torch.float32, k
    n_float = sum(v.is_floating_point() for v in sd.values())
    assert meta["weight_tensors"] == {"bfloat16": len(bf16), "float32": n_float - len(bf16)}
    save_serving(str(scratch / "bf16"), ep, meta)
    fn, _ = load_serving(str(scratch / "bf16"))
    x = torch.from_numpy(_frames(2, 9))
    with torch.inference_mode():
        _assert_equal(fn(x), predict_fn(bundle, True, keep)(x))


@pytest.mark.parametrize("args", [_Args, _Bf16], ids=["f32", "bf16"])
def test_poly_batch_bit_equal_at_every_batch(ckpt, scratch, args):
    """One artifact with a symbolic batch serves batches 1, 3 and 5, each
    bit-equal to the live program on the same frames."""
    bundle = _bundle(ckpt, args)
    ep, meta = export_predict(bundle, consistency=True, project_poi=True, keep=KEEP,
                              batch_size=4, poly_batch=True)
    assert meta["input"]["shape"] == ["b", H, W, 3] and meta["input"]["poly_batch"]
    assert meta["input"]["recommended_batch"] == 4
    save_serving(str(scratch / "poly"), ep, meta)
    fn, _ = load_serving(str(scratch / "poly"))
    live = predict_fn(bundle, True, KEEP)
    for b in (1, 3, 5):
        x = torch.from_numpy(_frames(b, b))
        with torch.inference_mode():
            got = fn(x)
            _assert_equal(got, live(x))
        assert got["theta"].shape == (b, 1, 3, 3)


def test_f32_artifact_matches_jax_artifact(ckpt, f32_artifact, scratch):
    """The same weights through JAX's StableHLO artifact and the port's
    torch.export artifact, on the same frames."""
    class JaxArgs(_Args):
        batchsize = 2

    jb = jax_build_model(JaxArgs, load=ckpt, warp_with_nearest=True, fold_bn=True)
    exported, meta = jax_export_predict(jb, consistency=True, project_poi=True,
                                        keep=("consist_score", "poi", "theta"), batch_size=2)
    jax_save_serving(str(scratch / "jax"), exported, meta)
    jfn, _ = jax_load_serving(str(scratch / "jax"))
    fn, _ = load_serving(f32_artifact[2])
    for seed in (11, 12):
        x = _frames(2, seed)
        want = jax.device_get(jfn(x))
        with torch.inference_mode():
            got = {k: v.numpy() for k, v in fn(torch.from_numpy(x)).items()}
        np.testing.assert_allclose(got["theta"], want["theta"], rtol=0, atol=2e-4)
        np.testing.assert_allclose(got["consist_score"], want["consist_score"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(got["poi"], want["poi"], rtol=0, atol=5e-4)


def test_graph_calls_the_operators(f32_artifact):
    """The program calls the four operators at the path's counts a batch
    (K2 with 4 two-input calls), and no plain version of the up-conv or of
    the warp: no ``conv_transpose2d``, no indexing gather; the only
    ``gather`` is the consistency cross entropy's pick; the remaining
    convs are the ResNet's and the UNet's 3-channel stem (cuDNN).  The
    casts of a tensor to its own dtype are gone from the graph."""
    bundle, ep, _ = f32_artifact
    calls = collections.Counter(str(n.target) for n in ep.graph.nodes
                                if n.op == "call_function")
    assert {k: calls[k] for k in PATH_OPS} == PATH_OPS
    dual = [n for n in ep.graph.nodes if str(n.target) == "sfh.conv3x3.default"
            and n.args[6] is not None]
    assert len(dual) == TWO_INPUT_K2
    assert not any("conv_transpose" in k or k.startswith("aten.index") for k in calls), calls
    assert calls["aten.gather.default"] == 1
    # no cast of a tensor to its own dtype, nor the dtype checks tracing adds
    assert "aten._assert_tensor_metadata.default" not in calls
    assert not any(n.target is torch.ops.aten.to.dtype
                   and n.args[0].meta["val"].dtype == n.args[1] for n in ep.graph.nodes)
    stn_convs = sum(isinstance(m, torch.nn.Conv2d) for m in bundle.model.resnet_reg.modules())
    assert calls["aten.conv2d.default"] == stn_convs + 1


def test_export_cli_writes_buckets(ckpt, scratch):
    """``cli.export_serving --buckets 1,2`` loads the checkpoint once and
    writes b1/ and b2/, each a fixed-batch program and its meta."""
    dst = scratch / "buckets"
    argv = ["--load", ckpt, "--req_outputs", "theta,consistency", "--device", "cpu",
            "--compute_dtype", "float32", "--out_size", str(W), str(H),
            "--court_img", COURT, "--court_poi", POI]
    records = export_serving.main(argv + ["--buckets", "2,1", "--dst", str(dst),
                                          "--platforms", "cpu"])
    assert [r["batch"] for r in records] == [1, 2]
    assert sorted(os.listdir(dst)) == ["b1", "b2"]
    for b in (1, 2):
        assert sorted(os.listdir(dst / f"b{b}")) == ["meta.json", "program.pt2"]
        meta = json.loads((dst / f"b{b}" / "meta.json").read_text())
        assert meta["input"]["shape"] == [b, H, W, 3]
        assert meta["outputs"] == ["consist_score", "theta"]
        assert meta["config"]["compute_dtype"] == "float32"
    bundle, consistency, _, keep = export_serving.build_bundle(get_prediction_args(argv))
    live = predict_fn(bundle, consistency, keep)
    for b in (1, 2):
        fn, _ = load_serving(str(dst / f"b{b}"), "cpu")
        x = torch.from_numpy(_frames(b, 5))
        with torch.inference_mode():
            _assert_equal(fn(x), live(x))


@pytest.mark.parametrize("extra,match", [
    (["--platforms", "tpu"], "cuda or cpu"),
    (["--platforms", "cuda"], "exported on"),
    (["--buckets", "1", "--poly_batch"], "mutually exclusive"),
])
def test_export_cli_refuses(ckpt, scratch, capsys, extra, match):
    with pytest.raises(SystemExit):
        export_serving.main(["--load", ckpt, "--device", "cpu", "--dst", str(scratch)] + extra)
    assert match in capsys.readouterr().err
    assert not os.listdir(scratch)


def test_load_serving_refuses_another_device(f32_artifact, scratch):
    """An artifact runs on the device type it was exported on: a CPU
    artifact refuses CUDA, and one recorded as CUDA refuses the CPU, before
    its program loads."""
    d = f32_artifact[2]
    with pytest.raises(ValueError, match="exported for"):
        load_serving(d, "cuda")
    meta = json.loads(open(os.path.join(d, "meta.json")).read())
    cuda = scratch / "cuda"
    cuda.mkdir()
    (cuda / "meta.json").write_text(json.dumps(dict(meta, platforms=["cuda"])))
    with pytest.raises(ValueError, match="exported for"):
        load_serving(str(cuda), "cpu")
    (cuda / "meta.json").write_text(json.dumps(dict(meta, format="jax.export/stablehlo")))
    with pytest.raises(ValueError, match="not torch.export"):
        load_serving(str(cuda), "cpu")


def test_loading_imports_no_model_code(f32_artifact):
    """A fresh interpreter that loads and calls the artifact imports the
    operators, not ``models/`` or ``cli/`` (and no jax)."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import numpy as np, torch
        from sports_field_homography_tpu_torch.compat.serving import load_serving
        fn, meta = load_serving({f32_artifact[2]!r}, "cpu")
        x = torch.from_numpy(np.zeros((2, {H}, {W}, 3), np.uint8))
        with torch.inference_mode():
            out = fn(x)
        assert sorted(out) == meta["outputs"], out
        bad = sorted(m for m in sys.modules if m.startswith(("sports_field_homography_tpu_torch.models",
                     "sports_field_homography_tpu_torch.cli", "jax", "sports_field_homography_tpu.")))
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"


def _op_cases():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.rand(*s, generator=g)  # noqa: E731
    x, w, b = r(2, 6, 8, 16), r(3, 3, 16, 8), r(8)
    m, i, be = r(16), r(16), r(16)
    labels = torch.randint(0, 4, (20, 30), generator=g, dtype=torch.uint8)
    theta = torch.eye(3).repeat(2, 1, 1) + 0.05 * r(2, 3, 3)
    values = template_value_table(np.arange(4, dtype=np.uint8), 4)
    ops = torch.ops.sfh
    return {
        "conv3x3": (ops.conv3x3.default, (x, w, None, None, None, None, None, None)),
        "conv3x3_prologue_two_input": (ops.conv3x3.default,
                                       (x, w, b, m, i, be, r(2, 6, 8, 4), r(3, 3, 4, 8))),
        "conv3x3_stats": (ops.conv3x3_stats.default, (x, w, b, m, i, be, None, None)),
        "deconv2x2": (ops.deconv2x2.default, (x, r(16, 2, 2, 8), b)),
        "bn_relu_norm": (ops.bn_relu_norm.default, (x, m, i, be)),
        "warp_nearest": (ops.warp_nearest.default, (labels, theta, values, [6, 8], None)),
        "warp_nearest_sampled": (ops.warp_nearest.default,
                                 (labels, theta, values, [12, 16], [6, 8])),
    }


@pytest.mark.parametrize("case", sorted(_op_cases()))
def test_opcheck(case):
    """``torch.library.opcheck`` on CPU tensors: the schema (no aliasing or
    mutation of the inputs), the fake implementation against the real one,
    and tracing with dynamic shapes."""
    op, args = _op_cases()[case]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_operators_follow_the_wrappers():
    """Each public wrapper returns its operator's output, and its operator
    the plain version's, on the CPU."""
    library.load_operators()
    x = torch.rand(1, 4, 5, 8)
    w = torch.rand(3, 3, 8, 8)
    assert torch.equal(conv3x3(x, w), torch.ops.sfh.conv3x3(x, w, *[None] * 6))
    wd, bd = torch.rand(8, 2, 2, 4), torch.rand(4)
    assert torch.equal(deconv2x2(x, wd, bd), torch.ops.sfh.deconv2x2(x, wd, bd))
    v = torch.rand(8)
    assert torch.equal(bn_relu_norm(x, v, v, v), torch.ops.sfh.bn_relu_norm(x, v, v, v))
    labels = torch.zeros(4, 4, dtype=torch.uint8)
    values = torch.arange(256, dtype=torch.float32)
    assert torch.equal(warp_nearest(labels, torch.eye(3)[None, None], (4, 4), values),
                       torch.ops.sfh.warp_nearest(labels, torch.eye(3)[None], values, [4, 4],
                                                  None))


@pytest.mark.parametrize("op", ["conv3x3", "deconv2x2", "bn_relu_norm", "warp_nearest"])
def test_mixed_devices_raise(op):
    """A call with tensors on two devices raises, through the operator as
    through the wrapper: no implementation moves a tensor or falls back."""
    fn, args = _op_cases()[op]
    args = list(args)
    args[1] = args[1].to("meta")
    with pytest.raises(ValueError, match="different devices"):
        fn(*args)


def test_bf16_batch_dependence_against_jax(ckpt, capsys):
    """ROADMAP queue 3's serving batch dependence, on the CPU: JAX's bf16
    predict program on 8 frames at once against each frame alone, and the
    port's (plain versions) likewise, on the same weights.  The port's
    theta may move no more than JAX's own."""
    class JaxArgs(_Bf16):
        batchsize = 8

    x = _frames(8, 3)
    keep = ("consist_score", "theta")
    jb = jax_build_model(JaxArgs, load=ckpt, warp_with_nearest=True, fold_bn=True)
    jfn = jit_predict_fn(jb, consistency=True, project_poi=False, keep=keep)
    j8 = np.asarray(jfn(jb.variables, x)["theta"])
    j1 = np.concatenate([np.asarray(jfn(jb.variables, x[i:i + 1])["theta"]) for i in range(8)])
    live = predict_fn(_bundle(ckpt, _Bf16), True, keep)
    with torch.inference_mode():
        p8 = live(torch.from_numpy(x))["theta"].numpy()
        p1 = np.concatenate([live(torch.from_numpy(x[i:i + 1]))["theta"].numpy()
                             for i in range(8)])
    jax_gap, port_gap = float(np.abs(j8 - j1).max()), float(np.abs(p8 - p1).max())
    with capsys.disabled():
        print(f"\nbf16 theta, 8 frames at once against alone, 64x36 resnet18: JAX (CPU) "
              f"{jax_gap:.3e}, the port (CPU) {port_gap:.3e}; theta spread across the "
              f"frames {float(j1.std(0).max()):.3e}; port against JAX, alone "
              f"{float(np.abs(p1 - j1).max()):.3e}")
    assert port_gap <= max(jax_gap, 1e-6)
