"""The port's phase spans (``utils/trace.py``) on the CPU: the recorder
itself, and the spans that ``predict_fn``, ``_to_host`` and ``train_step``
record on a tiny flagship (UNet deconv, ResNet18 on img+mask, 64x36,
float32)."""
import os
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sports_field_homography_tpu_torch.cli.engine import ModelBundle, predict_fn
from sports_field_homography_tpu_torch.cli.predict import _to_host
from sports_field_homography_tpu_torch.data.assets import open_court_template
from sports_field_homography_tpu_torch.data.synthetic import synthetic_samples
from sports_field_homography_tpu_torch.geometry.court import load_court_poi
from sports_field_homography_tpu_torch.models import Reconstructor, ReconstructorConfig
from sports_field_homography_tpu_torch.ops.warp import template_value_table
from sports_field_homography_tpu_torch.train.loop import LossConfig, train_step
from sports_field_homography_tpu_torch.train.optim import make_optimizer
from sports_field_homography_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "sports_field_homography_tpu_torch")
COURT = os.path.join(REPO, "assets", "mask_ncaa_v4_nc4_m_onehot.png")
POI = os.path.join(REPO, "assets", "template_ncaa_v4_points.json")
W, H = 64, 36
CFG = dict(target_size=(W, H), unet_size=(W, H), warp_size=(W, H), resnet_name="resnet18",
           resnet_input="img+mask")
# every span of the port: (file under the package, name)
SITES = {("cli/engine.py", "predict.batch"), ("cli/predict.py", "predict.to_host"),
         ("train/loop.py", "train.step"), ("train/loop.py", "train.loss"),
         ("train/loop.py", "train.backward"), ("train/loop.py", "train.update"),
         ("models/reconstructor.py", "model.unet"), ("models/reconstructor.py", "model.stn"),
         ("models/reconstructor.py", "model.warp")}


@pytest.fixture(autouse=True)
def _not_recording():
    trace.stop()
    yield
    trace.stop()


def _tree(records):
    """[(name, parent's name or None, unit)] in the order the spans opened."""
    return [(n, None if p is None else records[p][0], u) for n, _, _, p, u in records]


def _model(train: bool):
    torch.manual_seed(0)
    return Reconstructor(ReconstructorConfig(**CFG)).train(train)


def _frames(n, seed=0):
    rng = np.random.RandomState(seed)
    return synthetic_samples(n, COURT, POI, (W, H), rng=rng)


def test_off_returns_the_shared_object_and_reads_no_clock(monkeypatch):
    calls = []
    real = time.perf_counter_ns
    monkeypatch.setattr(time, "perf_counter_ns", lambda: calls.append(1) or real())
    a, b = trace.span("model.unet"), trace.span("train.step")
    assert a is b
    with a:
        with b:
            pass
    assert calls == [] and trace.stop() == []


def test_nested_spans_share_the_root_unit_and_a_raising_body_closes_its_span():
    trace.start()
    with trace.span("a"):
        with pytest.raises(ValueError):
            with trace.span("b"):
                raise ValueError("inside b")
        with trace.span("c"):
            pass
    with trace.span("d"):
        pass
    recs = trace.stop()
    assert _tree(recs) == [("a", None, 0), ("b", "a", 0), ("c", "a", 0), ("d", None, 3)]
    for _, t0, t1, parent, _ in recs:
        assert t0 <= t1
        if parent is not None:
            assert recs[parent][1] <= t0 and t1 <= recs[parent][2]


def test_two_rounds_give_separate_lists():
    trace.start()
    with trace.span("first"):
        first = trace.stop()        # stopped with the span open
    trace.start()
    with trace.span("second"):
        pass
    second = trace.stop()
    assert [r[0] for r in first] == ["first"] and first[0][2] is None
    assert _tree(second) == [("second", None, 0)]
    assert trace.stop() == []


def test_threads_nest_only_their_own_spans():
    """Eight threads record nested spans at once on a short switch
    interval: each span's parent is its own thread's, and each unit's
    spans are one thread's."""
    trace.start()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for i in range(50):
                with trace.span(f"root{t}"):
                    with trace.span(f"child{t}"):
                        with trace.span(f"leaf{t}"):
                            pass
        threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    recs = trace.stop()
    assert len(recs) == 8 * 50 * 3
    for i, (name, _, _, parent, unit) in enumerate(recs):
        t = name[-1]
        assert recs[unit][0] == f"root{t}" and recs[unit][3] is None
        if name.startswith("root"):
            assert parent is None and unit == i
        else:
            assert recs[parent][0] == ("root" if name.startswith("child") else "child") + t


def _bundle():
    labels = open_court_template(COURT, 4, size=(W, H))
    return ModelBundle(_model(False), torch.from_numpy(labels), template_value_table(labels, 4),
                       load_court_poi(POI).astype(np.float32), ReconstructorConfig(**CFG),
                       torch.device("cpu"))


@pytest.mark.parametrize("keep", [("theta", "consist_score"),
                                  ("theta", "consist_score", "warp_mask", "poi")])
def test_predict_fn_records_the_batch_and_its_model_phases(keep):
    fn = predict_fn(_bundle(), True, keep)
    frames = torch.from_numpy(_frames(2)[0])
    with torch.inference_mode():
        off = fn(frames)
        trace.start()
        on = fn(frames)
        recs = trace.stop()
    assert _tree(recs) == [("predict.batch", None, 0), ("model.unet", "predict.batch", 0),
                           ("model.stn", "predict.batch", 0),
                           ("model.warp", "predict.batch", 0)]
    assert sorted(on) == sorted(keep)
    for k in keep:
        assert torch.equal(on[k], off[k]), k


def test_to_host_records_its_span():
    preds = {"theta": torch.ones(2, 1, 3, 3)}
    trace.start()
    host, event = _to_host(preds, torch.device("cpu"))
    recs = trace.stop()
    assert _tree(recs) == [("predict.to_host", None, 0)]
    assert event is None and torch.equal(host["theta"], preds["theta"])


def _batch(n, seed):
    frames, labels, anno = _frames(n, seed)
    nz = anno[..., 2].astype(np.float32)
    return {"image": torch.from_numpy(frames), "mask": torch.from_numpy(labels.astype(np.int64)),
            "weight": torch.ones(n, 1), "poi": torch.from_numpy(anno[..., :2].astype(np.float32)),
            "nonzeros": torch.from_numpy(nz),
            "num_nonzero": torch.from_numpy(np.maximum(nz.sum(1), 1.0).astype(np.float32))}


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_records_the_step_and_its_phases(micro):
    model = _model(True)
    opt = make_optimizer("RMSprop", model.parameters(), 1e-4, 1e-6)
    template = torch.from_numpy(open_court_template(COURT, 4, size=(W, H))).float() / 4
    poi = torch.from_numpy(load_court_poi(POI).astype(np.float32))
    losses = LossConfig(seg_loss="focal", rec_loss="MSE", reproj_loss="RRMSE",
                        consist_loss="focal", consist_start_iter=0, batch_size=2)
    batches = [_batch(2, s) for s in range(micro)]
    trace.start()
    logs = train_step(model, opt, batches if micro > 1 else batches[0], 0, template, poi,
                      losses)
    recs = trace.stop()
    phases = [("model.unet", "train.step", 0), ("model.stn", "train.step", 0),
              ("model.warp", "train.step", 0), ("train.loss", "train.step", 0),
              ("train.backward", "train.step", 0)]
    assert _tree(recs) == ([("train.step", None, 0)] + phases * micro
                           + [("train.update", "train.step", 0)])
    assert torch.isfinite(logs["Tot_loss"])


def test_spans_sit_only_at_the_phase_sites():
    """The nine spans, each where its phase runs: none in the per-launch
    wrappers under ``ops/``."""
    found = set()
    for root, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                text = open(path).read()
                for name in re.findall(r"trace\.span\(\"([^\"]+)\"\)", text):
                    found.add((os.path.relpath(path, PACKAGE), name))
    assert found == SITES
