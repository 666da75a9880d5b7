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
                                                        warp_nearest)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "assets")
COURT = os.path.join(ASSETS, "mask_ncaa_v4_nc4_m_onehot.png")
SIZE = (128, 72)           # template (W, H)


@pytest.fixture(scope="module")
def court():
    table = build_interval_table(jax_template(COURT, 4, size=SIZE))
    labels = open_court_template(COURT, 4, size=SIZE)
    return table, labels, template_value_step(labels, 4)


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
    table, labels, step = court
    theta = _thetas(seed)
    got = warp_nearest(torch.from_numpy(labels), torch.from_numpy(theta),
                       out_hw, sample_hw=sample_hw, value_step=step).numpy()
    xla = np.asarray(warp_nearest_interval(table, jnp.asarray(theta), out_hw,
                                           sample_hw=sample_hw))
    pallas = np.asarray(warp_nearest_interval_pallas(
        table, jnp.asarray(theta), out_hw, sample_hw=sample_hw, interpret=True))
    assert got.shape == xla.shape == pallas.shape
    assert (got > 0).mean() > 0.2          # the court covers the frame
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)


def test_value_step_matches_interval_table(court):
    table, _, step = court
    assert step == table.value_step


def test_theta_b133_and_labels_times_classes(court):
    """(B, 1, 3, 3) theta is accepted, and label * step * classes gives the
    template's class labels back exactly."""
    _, labels, step = court
    theta = torch.from_numpy(np.tile(np.eye(3, dtype=np.float32), (2, 1, 1, 1)))
    out = warp_nearest(torch.from_numpy(labels), theta, SIZE[::-1], value_step=step)
    np.testing.assert_array_equal((out[0] * 4).to(torch.int32).numpy(), labels)
    np.testing.assert_array_equal(out[0].numpy(), out[1].numpy())
