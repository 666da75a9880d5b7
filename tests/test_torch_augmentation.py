"""The port's training augmentation and augmented samples against the JAX
package (CPU).

``data/augmentation.AugmentationPipeline`` against the JAX pipeline on the
same seeds: jitter, blur, hflip with the PoI symmetry map (the NCAA table
or a ``poi_flip_map`` file) and the UV u-inversion, and the ``scale`` crop
(Pillow).  Images within 1e-6, masks, UV maps, points and their order
exactly.  Then whole samples: the port's ``BasicDataset`` with
augmentation against the JAX dataset, through the deterministic
``(aug_seed, epoch, index)`` draw, as uint8 and float images; the UV
``.tif`` masks (cv2); and the refusals where Pillow or cv2 is missing.
"""
import json
import os

import numpy as np
import pytest

from sports_field_homography_tpu.data.augmentation import AugmentationPipeline as JaxAug
from sports_field_homography_tpu_torch.data import augmentation as aug_mod
from sports_field_homography_tpu_torch.data.augmentation import AugmentationPipeline

W, H = 64, 36
JITTER = {"brightness": 0.35, "contrast": 0.35, "saturation": 0.25, "hue": 0.25}
EXAMPLE = {"apperance": {"jitter": JITTER, "blur": 5}, "geometric": {"hflip": 0.5}}
CONFIGS = {
    "jitter": {"apperance": {"jitter": JITTER}},
    "jitter_partial": {"apperance": {"jitter": {"brightness": 0.4, "hue": 0.0}}},
    "blur": {"apperance": {"blur": 3}},
    "hflip": {"geometric": {"hflip": 0.5}},
    "example_conf": EXAMPLE,
    "scale": {"apperance": {"blur": 5}, "geometric": {"scale": [0.6, 1.0], "hflip": 0.5}},
}


def _sample(rng, poi=True, uv=True):
    img = rng.random((H, W, 3), dtype=np.float32)
    mask = rng.integers(0, 4, (H, W)).astype(np.int64)
    uvm = (rng.random((H, W, 2)) * (mask[..., None] > 0)).astype(np.float32) if uv else None
    pts = rng.random((52, 2)).astype(np.float32) if poi else None
    nz = (rng.random(52) > 0.3).astype(np.float32) if poi else None
    return img, mask, uvm, pts, nz


def _assert_same(got, want):
    names = ("image", "mask", "uv", "poi", "nonzeros")
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
        elif name == "image":
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=name)
        else:
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pipeline_matches_jax(name):
    aug = CONFIGS[name]
    ours, theirs = AugmentationPipeline(aug, (W, H), True), JaxAug(aug, (W, H), True)
    rng = np.random.default_rng(7)
    flipped = 0
    for seed in range(12):
        sample = _sample(rng, poi=name != "scale")
        got = ours(*[None if a is None else a.copy() for a in sample], seed=seed)
        want = theirs(*[None if a is None else a.copy() for a in sample], seed=seed)
        _assert_same(got, want)
        if "geometric" in aug and not np.array_equal(got[1], sample[1]):
            flipped += 1
    if name == "hflip" or name == "example_conf":
        assert 0 < flipped < 12      # both branches of the draw ran


def test_flip_moves_points_uv_and_mask():
    """A flip mirrors the mask, inverts u on court pixels, and sends each
    point of the NCAA symmetry map to its mirror, as JAX does."""
    ours = AugmentationPipeline({"geometric": {"hflip": 1.0}}, (W, H))
    img, mask, uv, poi, nz = _sample(np.random.default_rng(1))
    _, m2, uv2, p2, nz2 = ours(img, mask, uv.copy(), poi, nz, seed=0)
    np.testing.assert_array_equal(m2, mask[:, ::-1])
    court = mask[:, ::-1] > 0
    np.testing.assert_allclose(uv2[..., 0][court], 1.0 - uv[:, ::-1, 0][court], atol=1e-7)
    mapping = aug_mod.ncaa_poi_flip_mapping()
    for i, j in enumerate(mapping):
        np.testing.assert_allclose(p2[i], [1.0 - poi[j, 0], poi[j, 1]], atol=1e-7)
        assert nz2[i] == nz[j]


def test_poi_flip_map_file_matches_jax(tmp_path):
    path = tmp_path / "flip.json"
    path.write_text(json.dumps({"hflip": [3, 2, 1, 0, 5, 4]}))
    aug = {"geometric": {"hflip": 0.5, "poi_flip_map": str(path)}}
    ours, theirs = AugmentationPipeline(aug, (W, H)), JaxAug(aug, (W, H))
    rng = np.random.default_rng(3)
    for seed in range(6):
        sample = _sample(rng, uv=False)
        _assert_same(ours(*sample, seed=seed), theirs(*sample, seed=seed))


def test_scale_needs_pillow_and_the_rest_does_not(monkeypatch):
    monkeypatch.setattr(aug_mod, "have_pillow", lambda: False)
    with pytest.raises(RuntimeError, match="Pillow"):
        AugmentationPipeline({"geometric": {"scale": [0.8, 1.0]}}, (W, H))
    ours = AugmentationPipeline(EXAMPLE, (W, H))
    sample = _sample(np.random.default_rng(2))
    _assert_same(ours(*sample, seed=5), JaxAug(EXAMPLE, (W, H))(*sample, seed=5))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from sports_field_homography_tpu_torch.data.synthetic import write_synthetic_dataset

    root = tmp_path_factory.mktemp("aug_set")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    write_synthetic_dataset(str(root), 6, 1, f"{repo}/assets/mask_ncaa_v4_nc4_m_onehot.png",
                            f"{repo}/assets/template_ncaa_v4_points.json", size=(W, H), seed=2)
    return root


@pytest.mark.parametrize("raw_uint8", [True, False])
def test_augmented_samples_match_jax(synth, raw_uint8):
    """The per-sample seed from (aug_seed, epoch, index): the port's and
    the JAX dataset's augmented samples agree at every index and epoch,
    and differ between epochs."""
    from sports_field_homography_tpu.data.dataset import BasicDataset as JaxDataset
    from sports_field_homography_tpu_torch.data.dataset import BasicDataset, aug_sample_seed

    dirs = [str(synth / d) for d in ("frames", "masks", "anno")]
    ids = sorted(os.path.join("train_game", f) for f in os.listdir(synth / "frames" / "train_game"))
    keys = ["poi", "reproj_mse"]
    ours = BasicDataset(ids, dirs[0], (W, H), dirs[1], dirs[2], keys, aug=EXAMPLE,
                        aug_seed=4, raw_uint8=raw_uint8)
    theirs = JaxDataset(ids, *dirs, keys, 4, target_size=(W, H), aug=EXAMPLE,
                        raw_uint8=raw_uint8, aug_seed=4)
    images = {}
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(len(ids)):
            got, want = ours[i], theirs[i]
            assert got["name"] == want["name"]
            for k in ("mask", "poi", "nonzeros", "num_nonzero", "weight"):
                np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
            assert got["image"].dtype == want["image"].dtype
            np.testing.assert_allclose(got["image"].astype(np.float64),
                                       want["image"].astype(np.float64), rtol=0, atol=1e-6)
            images[epoch, i] = got["image"]
    assert any(not np.array_equal(images[0, i], images[1, i]) for i in range(len(ids)))
    seed = int(np.random.default_rng([4, 1, 3]).integers(2147483647))
    assert aug_sample_seed(4, 1, 3) == seed


def test_augmented_loader_is_deterministic(synth):
    """Two passes of one epoch give the same batches whatever the number
    of loader threads; a skipped pass yields the tail of the full one."""
    from sports_field_homography_tpu_torch.data.dataset import BasicDataset
    from sports_field_homography_tpu_torch.data.loader import Loader

    dirs = [str(synth / d) for d in ("frames", "masks", "anno")]
    ids = sorted(os.path.join("train_game", f) for f in os.listdir(synth / "frames" / "train_game"))

    def epoch(workers, skip=0):
        ds = BasicDataset(ids, dirs[0], (W, H), dirs[1], dirs[2], ["poi"], aug=EXAMPLE,
                          aug_seed=9, raw_uint8=False)
        loader = Loader(ds, 4, num_workers=workers, shuffle=True, seed=9)
        loader.set_epoch(1)
        loader.skip_next_batches(skip)
        return [(b["name"], b["image"], b["num_valid"]) for b in loader]

    a, b, tail = epoch(4), epoch(1), epoch(2, skip=1)
    assert [x[0] for x in a] == [x[0] for x in b] and [x[2] for x in a] == [4, 2]
    for (_, ia, _), (_, ib, _) in zip(a, b):
        np.testing.assert_array_equal(ia, ib)
    assert len(tail) == 1 and tail[0][0] == a[1][0]
    np.testing.assert_array_equal(tail[0][1], a[1][1])


def test_uv_masks_match_jax(tmp_path):
    """UV ``.tif`` masks (uint16: labels, u, v) through cv2: the port's
    samples equal the JAX dataset's, with and without a flip."""
    cv2 = pytest.importorskip("cv2")
    from PIL import Image

    from sports_field_homography_tpu.data.dataset import BasicDataset as JaxDataset
    from sports_field_homography_tpu_torch.data.dataset import BasicDataset

    rng = np.random.default_rng(6)
    for d in ("frames", "masks"):
        (tmp_path / d / "g").mkdir(parents=True)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (50, 90, 3), dtype=np.uint8)).save(
            tmp_path / "frames" / "g" / f"{i}.png")
        labels = rng.integers(0, 4, (50, 90))
        uv = rng.integers(0, 65536, (50, 90, 2)) * (labels[..., None] > 0)
        tif = np.concatenate([labels[..., None], uv], axis=-1).astype(np.uint16)
        assert cv2.imwrite(str(tmp_path / "masks" / "g" / f"{i}.tif"), tif)
    ids = [f"g/{i}.png" for i in range(3)]
    for aug in (None, {"geometric": {"hflip": 0.5}}):
        ours = BasicDataset(ids, str(tmp_path / "frames"), (W, H), str(tmp_path / "masks"),
                            use_uv=True, aug=aug, aug_seed=1)
        theirs = JaxDataset(ids, str(tmp_path / "frames"), str(tmp_path / "masks"),
                            num_classes=4, use_uv=True, target_size=(W, H), aug=aug,
                            raw_uint8=True, aug_seed=1)
        for i in range(3):
            got, want = ours[i], theirs[i]
            assert got["uv"].dtype == np.float32 and got["uv"].shape == (H, W, 2)
            np.testing.assert_array_equal(got["mask"], want["mask"])
            np.testing.assert_array_equal(got["uv"], want["uv"])
            np.testing.assert_array_equal(got["image"], want["image"])
