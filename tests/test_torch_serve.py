"""The port's online server against the JAX server (CPU, float32).

Both servers load the same JAX-written ``CP_epoch1.msgpack`` (a 64x36
resnet18 img+mask model from a numpy seed, theta kept near the identity so
that every point of interest projects near the frame) with its
``conf.yaml``, on port 0, and answer the same request bytes.  Bounds
(``docs/PARITY.md``): theta max-abs 2e-4, score 1e-3, poi 5e-4, decoded
warp-mask pixels differ on < 0.1 %.  The same checkpoint exported with
``cli.export_serving`` serves through ``--serving_artifact`` (bucket
directories, fixed and poly_batch programs), held to the live program bit
for bit and to the JAX package's artifact within those bounds.
"""
import base64
import http.client
import importlib.util
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from sports_field_homography_tpu.compat.serving import load_serving as jax_load_serving
from sports_field_homography_tpu.serve.server import create_server as jax_create_server
from sports_field_homography_tpu.utils.checkpoint import save_checkpoint
from sports_field_homography_tpu_torch.cli import export_serving
from sports_field_homography_tpu_torch.cli.engine import predict_fn
from sports_field_homography_tpu_torch.compat.serving import export_predict, save_serving
from sports_field_homography_tpu_torch.data.png import decode_png, encode_png
from sports_field_homography_tpu_torch.serve import server as port_server
from sports_field_homography_tpu_torch.serve.batcher import DynamicBatcher, _Pending
from sports_field_homography_tpu_torch.utils.config import get_prediction_args, get_serving_args
from test_torch_predict_full import near_identity_variables
from test_torch_isolation import png_with_filters
from test_torch_predict_cli import COURT, POI, H, W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REQ = "theta,poi,consistency,warp_mask"
COMMON = ["--port", "0", "--req_outputs", REQ, "--buckets", "1,2,4",
          "--max_delay_ms", "30", "--compute_dtype", "float32"]


def _write_ckpt(cp_dir):
    os.makedirs(cp_dir, exist_ok=True)
    conf = {"target_size": [W, H], "unet_size": [W, H], "warp_size": [W, H],
            "court_size": [W, H], "mask_classes": 4, "resnet_name": "resnet18",
            "resnet_input": "img+mask", "use_unet": True, "use_resnet": True,
            "compute_dtype": "float32", "court_img": COURT, "court_poi": POI}
    with open(os.path.join(cp_dir, "conf.yaml"), "w") as f:
        json.dump(conf, f)
    path = os.path.join(cp_dir, "CP_epoch1.msgpack")
    save_checkpoint(path, near_identity_variables(0))
    return path


def _serve(create, argv):
    httpd, batcher = create(argv)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, batcher, httpd.server_address[1]


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _post(port, body):
    status, _, data = _request(port, "POST", "/predict", body)
    return status, json.loads(data)


def _png(img_bgr):
    ok, buf = cv2.imencode(".png", img_bgr)
    assert ok
    return buf.tobytes()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    cp = _write_ckpt(str(tmp_path_factory.mktemp("serve_ckpt")))
    jax_httpd, jax_batcher, jax_port = _serve(jax_create_server, ["--load", cp] + COMMON)
    port_httpd, port_batcher, port_port = _serve(port_server.create_server,
                                                 ["--load", cp, "--device", "cpu"] + COMMON)
    yield {"jax": jax_port, "port": port_port, "batcher": port_batcher, "cp": cp}
    for httpd, batcher in ((jax_httpd, jax_batcher), (port_httpd, port_batcher)):
        httpd.shutdown()
        batcher.close()


def _assert_parity(got, want):
    np.testing.assert_allclose(got["theta"], want["theta"], rtol=0, atol=2e-4)
    assert abs(got["score"] - want["score"]) <= 1e-3
    np.testing.assert_allclose(got["poi"], want["poi"], rtol=0, atol=5e-4)


def _mask(body):
    return decode_png(base64.b64decode(body["warp_mask_png"]))


def test_predict_matches_jax_server(servers):
    """The same PNG bytes to both servers: theta, score, poi and the warp
    mask within the bounds; and the port's response equals the port's own
    ``predict_fn`` on the frame in the bucket it was served in (bucket 1:
    the same program on the same input, so equal bit for bit)."""
    img = np.random.default_rng(3).integers(0, 256, (H, W, 3), dtype=np.uint8)
    body = _png(img)
    b = servers["batcher"]
    before = dict(b.batch_hist)
    status, got = _post(servers["port"], body)
    assert status == 200, got
    assert {k: v - before.get(k, 0) for k, v in b.batch_hist.items()
            if v != before.get(k, 0)} == {1: 1}
    status, want = _post(servers["jax"], body)
    assert status == 200, want
    assert set(got) == set(want) == {"theta", "score", "poi", "warp_mask_png"}
    _assert_parity(got, want)
    got_mask, want_mask = _mask(got), _mask(want)
    assert got_mask.shape == want_mask.shape == (H, W)
    assert (got_mask != want_mask).mean() < 1e-3

    args = get_serving_args(["--load", servers["cp"], "--device", "cpu"] + COMMON)
    run_batch, frame_shape, device = port_server._build_from_checkpoint(args)
    assert frame_shape == (H, W, 3) and device.type == "cpu"
    with torch.inference_mode():
        direct = run_batch(torch.from_numpy(img[None]))
    assert got["theta"] == direct["theta"][0].double().reshape(3, 3).tolist()
    assert got["score"] == float(direct["consist_score"][0])
    assert got["poi"] == direct["poi"][0].double().tolist()
    np.testing.assert_array_equal(got_mask, direct["warp_mask"][0].numpy())


def test_healthz_stats_and_metrics_match_jax(servers):
    """The same keys in /healthz and /stats, the same metric names in
    /metrics (after a request each)."""
    img = np.random.default_rng(4).integers(0, 256, (H, W, 3), dtype=np.uint8)
    for side in ("port", "jax"):
        assert _post(servers[side], _png(img))[0] == 200
    status, _, health = _request(servers["port"], "GET", "/healthz")
    assert status == 200 and json.loads(health) == {"ok": True, "backend": "cpu"}
    views = {}
    for side in ("port", "jax"):
        status, _, stats = _request(servers[side], "GET", "/stats")
        assert status == 200
        status, ctype, text = _request(servers[side], "GET", "/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        names = {re.sub(r" \S+$", "", line) for line in text.decode().splitlines()}
        views[side] = json.loads(stats), names
    (stats, names), (jax_stats, jax_names) = views["port"], views["jax"]
    assert set(stats) == set(jax_stats)
    assert set(stats["latency_ms"]) == set(jax_stats["latency_ms"])
    assert stats["buckets"] == [1, 2, 4] and stats["requests"] >= 1
    assert names == jax_names, names ^ jax_names


def test_dynamic_batching_coalesces(servers):
    """8 concurrent posts in a 30 ms window: fewer batches than requests,
    and 8 distinct thetas (no slice mix-ups)."""
    b = servers["batcher"]
    before_req, before_bat = b.n_requests, b.n_batches
    rng = np.random.default_rng(5)
    bodies = [_png(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)) for _ in range(8)]
    results = [None] * 8

    def post(i):
        results[i] = _post(servers["port"], bodies[i])

    threads = [threading.Thread(target=post, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert all(r is not None and r[0] == 200 for r in results), results
    assert b.n_requests - before_req == 8
    assert b.n_batches - before_bat < 8
    assert len({json.dumps(r[1]["theta"]) for r in results}) == 8


def test_resizes_like_jax_server(servers):
    """A 2x-size frame is resized server-side (cv2, the video source's
    INTER_AREA), and its theta matches the JAX server's."""
    big = np.random.default_rng(7).integers(0, 256, (2 * H, 2 * W, 3), dtype=np.uint8)
    status, got = _post(servers["port"], _png(big))
    assert status == 200, got
    status, want = _post(servers["jax"], _png(big))
    assert status == 200, want
    _assert_parity(got, want)


def test_bad_request_and_unknown_path(servers):
    status, body = _post(servers["port"], b"this is not an image")
    assert status == 400 and "error" in body
    status, _, _ = _request(servers["port"], "GET", "/nope")
    assert status == 404
    status, _, _ = _request(servers["port"], "POST", "/nope", b"x")
    assert status == 404


def test_without_cv2_serves_pngs_at_frame_size(servers, monkeypatch):
    """Without cv2, a PNG at the frame size is served exactly as with cv2;
    another size and a JPEG get a 400 that names cv2."""
    img = np.random.default_rng(8).integers(0, 256, (H, W, 3), dtype=np.uint8)
    status, with_cv2 = _post(servers["port"], _png(img))
    assert status == 200
    monkeypatch.setattr(port_server, "have_cv2", lambda: False)
    status, without = _post(servers["port"], _png(img))
    assert status == 200 and without == with_cv2
    big = np.repeat(np.repeat(img, 2, axis=0), 2, axis=1)
    for body in (_png(big), cv2.imencode(".jpg", img)[1].tobytes()):
        status, resp = _post(servers["port"], body)
        assert status == 400 and "cv2" in resp["error"], resp


@pytest.mark.parametrize("kind", ["rgb", "gray", "rgba", "gray_alpha", "rgb_filtered"])
@pytest.mark.parametrize("order", ["bgr", "rgb"])
def test_decode_frame_with_and_without_cv2(monkeypatch, tmp_path, kind, order):
    """``_decode_frame`` without cv2 (``decode_png``) gives cv2's
    ``IMREAD_COLOR`` frame in the asked channel order, for every PNG colour
    type and for Pillow's filtered rows."""
    rng = np.random.default_rng(9)
    ch = {"rgb": 3, "gray": 1, "rgba": 4, "gray_alpha": 2, "rgb_filtered": 3}[kind]
    arr = rng.integers(0, 256, (H, W, ch), dtype=np.uint8)
    if kind == "rgb_filtered":      # smooth rows: Pillow picks Sub/Up/Average/Paeth
        arr = (np.cumsum(arr % 3, axis=1) % 256).astype(np.uint8)
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[ch]
    path = tmp_path / "frame.png"
    Image.fromarray(arr[..., 0] if ch == 1 else arr, mode).save(path, optimize=True)
    raw = path.read_bytes()
    with_cv2 = port_server._decode_frame(raw, (H, W), order)
    monkeypatch.setattr(port_server, "have_cv2", lambda: False)
    without = port_server._decode_frame(raw, (H, W), order)
    assert without.shape == (H, W, 3) and without.dtype == np.uint8
    np.testing.assert_array_equal(without, with_cv2)
    bgr = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(without, bgr if order == "bgr" else bgr[..., ::-1])


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "0_but_the_last_row"])
def test_png_decode_every_filter_equals_pillow(tmp_path, ftype):
    """Each filter type on every row, and filter 0 on every row but the
    last (Paeth), which the filter-0 shortcut must not take, decode equal
    to Pillow and to the source (every type mixed row by row:
    ``test_torch_isolation.py::test_png_reader_every_filter_type``)."""
    img = np.random.default_rng(10).integers(0, 256, (29, 41, 3), dtype=np.uint8)
    h = img.shape[0]
    ftypes = [4 if r == h - 1 else 0 for r in range(h)] if ftype == "0_but_the_last_row" \
        else [ftype] * h
    data = png_with_filters(img, ftypes)
    (tmp_path / "f.png").write_bytes(data)
    np.testing.assert_array_equal(np.array(Image.open(tmp_path / "f.png")), img)
    np.testing.assert_array_equal(decode_png(data), img)


def test_png_filter0_frame_decodes_to_its_source():
    """``encode_png`` writes filter 0 on every row: the shortcut returns the
    source frame, writable, for RGB and gray."""
    rng = np.random.default_rng(11)
    for img in (rng.integers(0, 256, (360, 640, 3), dtype=np.uint8),
                rng.integers(0, 256, (36, 64), dtype=np.uint8)):
        got = decode_png(encode_png(img))
        np.testing.assert_array_equal(got, img)
        assert got.flags.writeable and got.flags.c_contiguous


def test_batcher_error_propagation():
    def boom(frames):
        raise RuntimeError("device on fire")

    b = DynamicBatcher(boom, (4, 4, 3), max_batch=2, max_delay_ms=1, buckets=(2,),
                       device="cpu")
    with pytest.raises(RuntimeError, match="device on fire"):
        b.submit(np.zeros((4, 4, 3), np.uint8), timeout=30)
    with pytest.raises(ValueError, match="frame shape"):
        b.submit(np.zeros((5, 4, 3), np.uint8))
    assert b.stats()["errors"] == 1
    with pytest.raises(RuntimeError, match="device on fire"):
        b.warmup()
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(np.zeros((4, 4, 3), np.uint8))


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_batcher_dead_worker_raises_instead_of_hanging():
    """A worker thread that dies (an exception the worker does not deliver)
    makes warmup() and submit() raise instead of waiting forever."""
    def fatal(frames):
        raise SystemExit("worker gone")

    b = DynamicBatcher(fatal, (4, 4, 3), max_batch=2, max_delay_ms=1, buckets=(2,),
                       device="cpu")
    with pytest.raises(RuntimeError, match="worker thread died"):
        b.warmup()
    with pytest.raises(RuntimeError, match="worker thread died"):
        b.submit(np.zeros((4, 4, 3), np.uint8))
    b.close()


def test_batcher_pads_by_repeating_frame_0():
    seen = []

    def run(frames):
        seen.append(frames.clone())
        return {"y": frames.sum(dim=(1, 2, 3))}

    b = DynamicBatcher(run, (2, 2, 3), max_batch=4, max_delay_ms=1, buckets=(4,),
                       device="cpu")
    out = b.submit(np.full((2, 2, 3), 7, np.uint8), timeout=30)
    b.close()
    assert int(out["y"]) == 7 * 12
    assert seen[0].shape == (4, 2, 2, 3) and bool((seen[0] == 7).all())
    assert b.stats()["batch_hist"] == {4: 1} and b.stats()["mean_occupancy"] == 1


def test_batcher_stress_many_threads():
    """64 submitting threads (more than this machine's cores), a tiny switch
    interval: every request gets its own frame's result and the counters
    add up (a lost update or a slice mix-up would break either)."""
    b = DynamicBatcher(lambda frames: {"y": frames.long().sum(dim=(1, 2, 3))}, (2, 2, 3),
                       max_batch=8, max_delay_ms=1, buckets=(1, 2, 4, 8), device="cpu")
    wrong, interval = [], sys.getswitchinterval()

    def client(c):
        for j in range(10):
            v = (c * 10 + j) % 256
            out = b.submit(np.full((2, 2, 3), v, np.uint8), timeout=60)
            if int(out["y"]) != 12 * v:
                wrong.append((c, j, int(out["y"])))

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    stats = b.stats()
    b.close()
    assert not wrong, wrong[:5]
    assert stats["requests"] == 640 and stats["errors"] == 0
    assert sum(stats["batch_hist"].values()) == stats["batches"]
    assert stats["mean_occupancy"] * stats["batches"] == pytest.approx(640)


def test_batcher_close_fails_stragglers():
    """A request that lands in the queue only after the worker's shutdown
    drain must be failed by close(), not left blocked forever."""
    b = DynamicBatcher(lambda frames: {"y": frames.sum(dim=(1, 2, 3))}, (4, 4, 3),
                       max_batch=2, max_delay_ms=1, buckets=(2,), device="cpu")
    b._closed = True
    b._q.put(None)
    b._worker.join(timeout=30)
    assert not b._worker.is_alive()
    straggler = _Pending(np.zeros((4, 4, 3), np.uint8))
    b._q.put(straggler)
    b.close()
    assert straggler.event.is_set()
    assert isinstance(straggler.error, RuntimeError)


@pytest.mark.parametrize("extra,match", [
    (["--num_devices", "2"], "multi-device"),
])
def test_refuses_before_building(monkeypatch, extra, match):
    built = []
    monkeypatch.setattr(port_server, "build_model", lambda *a, **k: built.append(1))
    with pytest.raises(NotImplementedError, match=match):
        port_server.create_server(["--port", "0", "--device", "cpu"] + extra)
    assert not built


def test_failed_start_closes_the_batcher(servers, monkeypatch):
    """A warm-up that fails (a kernel that does not build or launch) fails
    the start and closes the batcher's worker, retrying nothing."""
    made = []

    class Failing(port_server.DynamicBatcher):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

        def warmup(self):
            raise RuntimeError("kernel build failed")

    monkeypatch.setattr(port_server, "DynamicBatcher", Failing)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        port_server.create_server(["--load", servers["cp"], "--device", "cpu"] + COMMON)
    assert len(made) == 1 and made[0]._closed and not made[0]._worker.is_alive()


def test_defaults_to_cuda_and_raises_without_it(servers):
    """``--device`` defaults to cuda; on a machine without CUDA the server
    raises at start, with no fallback to the CPU."""
    assert get_serving_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises((RuntimeError, AssertionError)):
        port_server.create_server(["--load", servers["cp"], "--port", "0"])


def test_sigterm_drains_in_flight(servers):
    """SIGTERM with 3 requests parked in a 2 s batch window, through
    ``python -m ...serve.server``: all answered 200, exit code 0."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "sports_field_homography_tpu_torch.serve.server",
         "--load", servers["cp"], "--port", "0", "--device", "cpu",
         "--req_outputs", "theta,consistency", "--buckets", "4",
         "--max_delay_ms", "2000", "--compute_dtype", "float32"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port, lines = None, []
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            lines.append(line)
            m = re.search(r"serving on http://[\d.]+:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
            assert proc.poll() is None, "".join(lines)[-2000:]
        assert port, "".join(lines)[-2000:]
        results, lock = [], threading.Lock()

        def client(seed):
            img = np.random.default_rng(seed).integers(0, 256, (H, W, 3), dtype=np.uint8)
            try:
                status, body = _post(port, _png(img))
                ok = status == 200 and np.isfinite(body["theta"]).all()
                with lock:
                    results.append(ok or (status, body))
            except Exception as e:  # noqa: BLE001 - collected, asserted below
                with lock:
                    results.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.5)          # the requests are parked in the 2 s window
        proc.send_signal(signal.SIGTERM)
        for t in threads:
            t.join(timeout=120)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out[-2000:]
    assert results == [True, True, True], results


# -- the exported program (--serving_artifact): cli.export_serving on the same
# checkpoint, f32 on the CPU, as JAX tests/test_serve.py:255-300 serves its own

ART_REQ = "theta,poi,consistency"


def _export_argv(cp):
    return ["--load", cp, "--req_outputs", ART_REQ, "--device", "cpu",
            "--compute_dtype", "float32", "--out_size", str(W), str(H),
            "--court_img", COURT, "--court_poi", POI]


@pytest.fixture(scope="module")
def artifacts(servers, tmp_path_factory):
    """``b1``/``b2`` bucket artifacts, one fixed-batch (2) artifact and one
    poly_batch artifact of theta, poi and the score, and the live program
    they were exported from."""
    root = tmp_path_factory.mktemp("artifacts")
    argv = _export_argv(servers["cp"])
    export_serving.main(argv + ["--buckets", "1,2", "--dst", str(root / "buckets")])
    bundle, consistency, project_poi, keep = export_serving.build_bundle(
        get_prediction_args(argv))
    for name, poly, dtype in (("fixed", False, "uint8"), ("fixed_float32_input", False, "float32"),
                              ("poly", True, "uint8")):
        ep, meta = export_predict(bundle, consistency, project_poi, keep, batch_size=2,
                                  input_dtype=dtype, poly_batch=poly)
        save_serving(str(root / name), ep, meta)
    yield {"root": root, "live": predict_fn(bundle, consistency, keep)}
    shutil.rmtree(root, ignore_errors=True)     # 160 MB a program


def _art_serve(path, *extra):
    return _serve(port_server.create_server,
                  ["--serving_artifact", str(path), "--port", "0", "--device", "cpu",
                   "--max_delay_ms", "200"] + list(extra))


def _stop(httpd, batcher):
    httpd.shutdown()
    httpd.server_close()
    batcher.close()


def _direct(live, imgs):
    with torch.inference_mode():
        out = live(torch.from_numpy(np.stack(imgs)))
    return [{"theta": out["theta"][i].double().reshape(3, 3).tolist(),
             "score": float(out["consist_score"][i]),
             "poi": out["poi"][i].double().tolist()} for i in range(len(imgs))]


def _concurrent(port, bodies):
    out = [None] * len(bodies)

    def post(i):
        out[i] = _post(port, bodies[i])

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return out


@pytest.mark.parametrize("name", ["fixed", "fixed_float32_input"])
def test_serve_artifact_fixed_batch(artifacts, name):
    """A fixed-batch artifact pins the batcher to its batch: a lone request
    is padded to it, and answered as the program answers the padded batch
    (an artifact that takes float32 frames gets the uint8 frame / 255)."""
    httpd, batcher, port = _art_serve(artifacts["root"] / name)
    try:
        assert batcher.buckets == (2,)
        img = np.random.default_rng(21).integers(0, 256, (H, W, 3), dtype=np.uint8)
        status, body = _post(port, _png(img))
        assert status == 200, body
        assert set(body) == {"theta", "score", "poi"}
        assert body == _direct(artifacts["live"], [img, img])[0]
        assert batcher.stats()["batch_hist"] == {2: 1}
        status, _, health = _request(port, "GET", "/healthz")
        assert json.loads(health) == {"ok": True, "backend": "cpu"}
    finally:
        _stop(httpd, batcher)


def test_serve_artifact_bucket_dir(artifacts):
    """A directory of b{N} artifacts serves exactly those buckets: a lone
    request in b1, two at once in b2, each answered bit for bit as the live
    program answers that batch."""
    httpd, batcher, port = _art_serve(artifacts["root"] / "buckets")
    try:
        assert batcher.buckets == (1, 2)
        rng = np.random.default_rng(22)
        imgs = [rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for _ in range(3)]
        status, alone = _post(port, _png(imgs[0]))
        assert status == 200 and alone == _direct(artifacts["live"], imgs[:1])[0]
        pair = _concurrent(port, [_png(i) for i in imgs[1:]])
        assert batcher.stats()["batch_hist"] == {1: 1, 2: 1}, batcher.stats()
        assert [b for _, b in pair] == _direct(artifacts["live"], imgs[1:])
    finally:
        _stop(httpd, batcher)


def test_serve_artifact_matches_jax_artifact(artifacts, servers, tmp_path):
    """The port's server on its bucket artifacts against the JAX package's
    artifact from the same checkpoint and flags (``scripts/export_serving.py``)
    on the same frame: theta 2e-4, score 1e-3, poi 5e-4."""
    spec = importlib.util.spec_from_file_location(
        "jax_export_serving", os.path.join(REPO, "scripts", "export_serving.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    argv = [a for a in _export_argv(servers["cp"]) if a not in ("--device", "cpu")]
    script.main(argv + ["--buckets", "1", "--dst", str(tmp_path / "jax")])
    jfn, _ = jax_load_serving(str(tmp_path / "jax" / "b1"))
    shutil.rmtree(tmp_path / "jax")         # loaded; 320 MB on disk
    httpd, batcher, port = _art_serve(artifacts["root"] / "buckets")
    try:
        for seed in (23, 24):
            img = np.random.default_rng(seed).integers(0, 256, (H, W, 3), dtype=np.uint8)
            status, got = _post(port, _png(img))
            assert status == 200, got
            want = jfn(img[None])
            _assert_parity(got, {"theta": np.asarray(want["theta"][0]).reshape(3, 3),
                                 "score": float(want["consist_score"][0]),
                                 "poi": np.asarray(want["poi"][0])})
    finally:
        _stop(httpd, batcher)


@pytest.mark.parametrize("extra,buckets", [(["--buckets", "3,1"], (1, 3)),
                                           (["--max_batch", "4"], (1, 2, 4))])
def test_serve_artifact_poly_batch_buckets(artifacts, extra, buckets):
    """A poly_batch artifact serves the server's buckets: ``--buckets``, else
    powers of two up to ``--max_batch``; warm-up runs each."""
    httpd, batcher, port = _art_serve(artifacts["root"] / "poly", *extra)
    try:
        assert batcher.buckets == buckets
        img = np.random.default_rng(25).integers(0, 256, (H, W, 3), dtype=np.uint8)
        status, body = _post(port, _png(img))
        assert status == 200 and body == _direct(artifacts["live"], [img])[0]
    finally:
        _stop(httpd, batcher)


def test_serve_artifact_refuses_disagreeing_frames(artifacts, tmp_path):
    """Bucket artifacts that disagree on the frame size are refused before
    any program loads."""
    root = tmp_path / "mixed"
    meta = json.loads((artifacts["root"] / "buckets" / "b2" / "meta.json").read_text())
    for b, h in ((1, H), (2, 2 * H)):            # the metas alone: refused before any load
        (root / f"b{b}").mkdir(parents=True)
        meta["input"]["shape"][:2] = [b, h]
        (root / f"b{b}" / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="disagree on the frame size"):
        port_server.create_server(["--serving_artifact", str(root), "--port", "0",
                                   "--device", "cpu"])


def test_serve_artifact_refuses_another_device(artifacts):
    """An artifact exported on the CPU refuses the default device (cuda),
    with no fallback; the server does not start."""
    with pytest.raises(ValueError, match="exported for"):
        port_server.create_server(["--serving_artifact", str(artifacts["root"] / "fixed"),
                                   "--port", "0"])


def test_serve_artifact_ignores_num_devices(artifacts, capsys):
    """``--num_devices`` above 1 with an artifact is logged and ignored, as
    the JAX server does (a checkpoint refuses it: ``test_refuses_before_building``)."""
    httpd, batcher, port = _art_serve(artifacts["root"] / "fixed", "--num_devices", "2",
                                      "--no_warmup")
    try:
        assert "--num_devices is ignored" in capsys.readouterr().out
        img = np.zeros((H, W, 3), np.uint8)
        assert _post(port, _png(img))[0] == 200
    finally:
        _stop(httpd, batcher)
