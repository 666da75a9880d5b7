"""K1: the port's nearest warp against the JAX interval warps (CPU).

Inputs come from a numpy seed; the port runs its plain PyTorch version
(CPU tensors), the JAX side both its XLA interval warp and the Pallas
kernel in interpret mode.  Labels must be exactly equal.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sports_field_homography_tpu.data.assets import open_court_template as jax_template
from sports_field_homography_tpu.ops.interval_warp import (build_interval_table,
                                                           warp_nearest_interval)
from sports_field_homography_tpu.ops.warp_pallas import warp_nearest_interval_pallas
from sports_field_homography_tpu_torch.data.assets import open_court_template
from sports_field_homography_tpu_torch.ops.warp import (template_value_step,
                                                        template_value_table,
                                                        warp_nearest)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "assets")
COURT = os.path.join(ASSETS, "mask_ncaa_v4_nc4_m_onehot.png")
SIZE = (128, 72)           # template (W, H)


@pytest.fixture(scope="module")
def court():
    table = build_interval_table(jax_template(COURT, 4, size=SIZE))
    labels = open_court_template(COURT, 4, size=SIZE)
    return table, labels, template_value_table(labels, 4)


def _thetas(seed, b=4):
    rng = np.random.default_rng(seed)
    scale = np.array([[0.1, 0.1, 0.2], [0.1, 0.1, 0.2], [0.05, 0.05, 0.0]])
    return (np.eye(3) + rng.standard_normal((b, 3, 3)) * scale).astype(np.float32)


@pytest.mark.parametrize("out_hw,sample_hw", [
    ((72, 128), None),          # full grid at the template's size
    ((60, 100), None),          # full grid, another size
    ((72, 128), (36, 64)),      # consistency subgrid, 2x
    ((90, 160), (36, 64)),      # subgrid, non-integer ratio
])
@pytest.mark.parametrize("seed", [0, 1])
def test_warp_labels_equal_jax(court, out_hw, sample_hw, seed):
    table, labels, values = court
    theta = _thetas(seed)
    got = warp_nearest(torch.from_numpy(labels), torch.from_numpy(theta),
                       out_hw, values, sample_hw=sample_hw).numpy()
    xla = np.asarray(warp_nearest_interval(table, jnp.asarray(theta), out_hw,
                                           sample_hw=sample_hw))
    pallas = np.asarray(warp_nearest_interval_pallas(
        table, jnp.asarray(theta), out_hw, sample_hw=sample_hw, interpret=True))
    assert got.shape == xla.shape == pallas.shape
    assert (got > 0).mean() > 0.2          # the court covers the frame
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)


def test_value_step_matches_interval_table(court):
    table, labels, _ = court
    assert template_value_step(labels, 4) == table.value_step


def test_theta_b133_and_labels_times_classes(court):
    """(B, 1, 3, 3) theta is accepted, and label * step * classes gives the
    template's class labels back exactly."""
    _, labels, values = court
    theta = torch.from_numpy(np.tile(np.eye(3, dtype=np.float32), (2, 1, 1, 1)))
    out = warp_nearest(torch.from_numpy(labels), theta, SIZE[::-1], values)
    np.testing.assert_array_equal((out[0] * 4).to(torch.int32).numpy(), labels)
    np.testing.assert_array_equal(out[0].numpy(), out[1].numpy())


# ---- a template that skips a label -------------------------------------------

GAP_HW = (36, 64)


def _gap_labels():
    """A (36, 64) uint8 template holding only labels {0, 2} of 4 classes:
    the interval table's value step is 0.5, not 0.25."""
    rng = np.random.default_rng(3)
    labels = np.zeros(GAP_HW, np.uint8)
    for r in range(GAP_HW[0]):
        lo, hi = sorted(rng.integers(0, GAP_HW[1], 2))
        labels[r, lo:hi + 1] = 2
    return labels


@pytest.mark.parametrize("which", ["gap", "ncaa"])
def test_value_table_matches_interval_table_codes(court, which):
    """The per-label table equals the interval table's code x value_step for
    every label the template holds, on the gap template and on NCAA."""
    labels = _gap_labels() if which == "gap" else court[1]
    values = template_value_table(labels, 4).numpy()
    table = build_interval_table(labels.astype(np.float32) / 4.0)
    k = table.K
    codes = np.asarray(table.table, np.float32)[:, 2 * k:]
    step = np.float32(table.value_step)
    for r in range(labels.shape[0]):          # each row's first value is labels[r, 0]
        assert values[labels[r, 0]] == np.float32(codes[r, 0] * step)
    present = np.unique(labels)
    want = np.round(present.astype(np.float32) / np.float32(4.0) / step) * step
    np.testing.assert_array_equal(values[present], want.astype(np.float32))
    if which == "gap":
        assert step == np.float32(0.5) and values[2] == np.float32(0.5)
    else:
        np.testing.assert_array_equal(values[:4], np.arange(4, dtype=np.float32) * step)


@pytest.mark.parametrize("sample_hw", [None, (18, 32)])
def test_gap_template_equals_jax(sample_hw):
    """K1 on a template that skips a label equals JAX's interval warp value
    for value, full grid and ``sample_hw``, and its consistency labels stay
    inside the 4 classes."""
    labels = _gap_labels()
    table = build_interval_table(labels.astype(np.float32) / 4.0)
    theta = _thetas(4, b=3)
    theta[0] = np.eye(3, dtype=np.float32)
    got = warp_nearest(torch.from_numpy(labels), torch.from_numpy(theta), GAP_HW,
                       template_value_table(labels, 4), sample_hw=sample_hw).numpy()
    want = np.asarray(warp_nearest_interval(table, jnp.asarray(theta), GAP_HW,
                                            sample_hw=sample_hw))
    assert (got == 0.5).any() and not (got > 0.5).any()
    np.testing.assert_array_equal(got, want)
    assert ((got * 4).astype(np.int32) < 4).all()
