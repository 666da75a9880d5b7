"""What the CUDA K1 (``csrc/warp_nearest.cu``) and K7-bwd
(``csrc/bn_relu_bwd.cu``) take from the host, checked on the CPU.

K1: the f32 grid constants the wrapper caches are those the warp grids use
(``geometry/warp.py`` and the JAX package's ``ops/interval_warp.py``), and a
numpy float32 emulation of the kernel's arithmetic -- the row terms
hoisted, 4 adjacent columns a thread, every operation rounded on its own in
the kernel's order -- gives the labels of ``warp_nearest_plain`` and of JAX's
``warp_nearest_interval`` exactly, on the predict and test-CLI grids.  A
reordering of the kernel's arithmetic fails here before it reaches a card.

K7-bwd: the route choice is a pure function of dtype, C and alignment; the
row schedule covers every row once with no thread summing more than 4096
rows in sequence; and the plain version agrees with JAX's ``_bn_relu_bwd``
on bf16 inputs.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sports_field_homography_tpu.data.assets import open_court_template as jax_template
from sports_field_homography_tpu.ops import double_conv as jax_dc
from sports_field_homography_tpu.ops.interval_warp import (_nearest_subsample_idx,
                                                           build_interval_table,
                                                           warp_nearest_interval)
from sports_field_homography_tpu_torch.data.assets import open_court_template
from sports_field_homography_tpu_torch.geometry import warp as geo
from sports_field_homography_tpu_torch.ops import bn_relu_bwd as k7
from sports_field_homography_tpu_torch.ops import warp as k1

COURT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "assets", "mask_ncaa_v4_nc4_m_onehot.png")
F32 = np.float32


def _bits(v):
    return np.float32(v).view(np.uint32)


# ---- K1: the cached grid constants -------------------------------------------

GRIDS = [((720, 1280), (360, 640)),      # predict: the consistency subgrid
         ((360, 640), None),             # test CLI: the full grid
         ((720, 1280), (359, 641)),      # odd subgrid ratios
         ((90, 160), (36, 64)),          # non-integer ratio
         ((29, 41), None)]               # odd full grid


@pytest.mark.parametrize("out_hw,sample_hw", GRIDS)
def test_grid_constants_are_the_grids_f32(out_hw, sample_hw):
    x_step, y_step, x_ratio, y_ratio = k1.grid_constants(out_hw, sample_hw)
    (full_h, full_w), (ho, wo) = out_hw, sample_hw or out_hw
    assert all(float(np.float32(v)) == v for v in (x_step, y_step, x_ratio, y_ratio))
    # what geometry/warp.py and the JAX package multiply by
    assert _bits(x_step) == _bits(geo._f32(2.0 / (full_w - 1)))
    assert _bits(y_step) == _bits(geo._f32(2.0 / (full_h - 1)))
    assert _bits(x_step) == np.asarray(jnp.float32(1.0) * (2.0 / (full_w - 1))).view(np.uint32)
    # the axes rebuilt from the constants equal the grids' axes bit for bit
    for n, step in ((full_w, x_step), (full_h, y_step)):
        want = geo._axis(n, None).numpy()
        np.testing.assert_array_equal((np.arange(n, dtype=F32) * F32(step) - F32(1)).view(np.uint32),
                                      want.view(np.uint32))
    if sample_hw is not None:
        for n_full, n_sub, ratio in ((full_w, wo, x_ratio), (full_h, ho, y_ratio)):
            idx = np.minimum(np.floor(np.arange(n_sub, dtype=F32) * F32(ratio)), F32(n_full - 1))
            np.testing.assert_array_equal(idx, geo._subsample_index(n_full, n_sub, None).numpy())
            np.testing.assert_array_equal(idx, np.asarray(_nearest_subsample_idx(n_full, n_sub)))
    else:
        assert x_ratio == 1.0 and y_ratio == 1.0


def test_grid_constants_are_cached():
    k1.grid_constants.cache_clear()
    a = k1.grid_constants((720, 1280), (360, 640))
    b = k1.grid_constants((720, 1280), (360, 640))
    assert a is b and k1.grid_constants.cache_info().hits == 1


# ---- K1: the kernel's arithmetic, emulated in numpy float32 -------------------

def _emulate_k1(labels, values, theta, out_hw, sample_hw):
    """csrc/warp_nearest.cu in numpy float32: per row the sampled row, its
    grid y and theta's three y products once; per thread 4 adjacent
    columns; each operation rounded on its own, sums in the kernel's order
    (t0*gx + t1*gy) + t2, 1 / (z + eps) correctly rounded (__frcp_rn),
    round half to even (rintf)."""
    ht, wt = labels.shape
    x_step, y_step, x_ratio, y_ratio = (F32(v) for v in k1.grid_constants(out_hw, sample_hw))
    full_h, full_w = out_hw
    ho, wo = sample_hw or out_hw
    assert wo % 4 == 0                       # the float4 route
    eps, one, half = F32(1e-8), F32(1), F32(0.5)
    fy = np.arange(ho, dtype=F32)
    fx = np.arange(wo, dtype=F32).reshape(wo // 4, 4)          # 4 columns a thread
    if sample_hw is not None:
        fy = np.minimum(np.floor(fy * y_ratio), F32(full_h - 1))
        fx = np.minimum(np.floor(fx * x_ratio), F32(full_w - 1))
    gy = (fy * y_step - one)[:, None, None]                    # one a row
    gx = (fx * x_step - one)[None]
    out = np.zeros((theta.shape[0], ho, wo // 4, 4), F32)
    for b, th in enumerate(theta.reshape(-1, 9).astype(F32)):
        xy, yy, zy = th[1] * gy, th[4] * gy, th[7] * gy        # hoisted row products
        px = (th[0] * gx + xy) + th[2]
        py = (th[3] * gx + yy) + th[5]
        pz = (th[6] * gx + zy) + th[8]
        with np.errstate(divide="ignore"):
            scale = np.where(np.abs(pz) > eps, one / (pz + eps), one).astype(F32)
        u = ((px * scale + one) * F32(wt) - one) * half
        v = ((py * scale + one) * F32(ht) - one) * half
        iu, iv = np.rint(u), np.rint(v)
        ok = (iu >= 0) & (iu < wt) & (iv >= 0) & (iv < ht)
        lab = labels[np.where(ok, iv, 0).astype(np.int64), np.where(ok, iu, 0).astype(np.int64)]
        out[b] = np.where(ok, values[lab], F32(0))
    return out.reshape(theta.shape[0], ho, wo)


def _thetas(seed, b=2):
    rng = np.random.default_rng(seed)
    scale = np.array([[0.1, 0.1, 0.2], [0.1, 0.1, 0.2], [0.05, 0.05, 0.0]])
    return (np.eye(3) + rng.standard_normal((b, 3, 3)) * scale).astype(F32)


@pytest.fixture(scope="module", params=["predict", "test_cli"])
def path(request):
    """(template labels, value table, interval table, out_hw, sample_hw) of
    the predict path (1280x720 template, sampled 360x640) and the test CLI
    (640x360 template, full grid)."""
    if request.param == "predict":
        size, out_hw, sample_hw = (1280, 720), (720, 1280), (360, 640)
    else:
        size, out_hw, sample_hw = (640, 360), (360, 640), None
    labels = open_court_template(COURT, 4, size=size)
    table = build_interval_table(jax_template(COURT, 4, size=size))
    return labels, k1.template_value_table(labels, 4).numpy(), table, out_hw, sample_hw


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_emulated_kernel_order_equals_plain_and_jax(path, seed):
    labels, values, table, out_hw, sample_hw = path
    theta = _thetas(seed)
    got = _emulate_k1(labels, values, theta, out_hw, sample_hw)
    plain = k1.warp_nearest_plain(torch.from_numpy(labels), torch.from_numpy(theta), out_hw,
                                  torch.from_numpy(values), sample_hw).numpy()
    jax_out = np.asarray(warp_nearest_interval(table, jnp.asarray(theta), out_hw,
                                               sample_hw=sample_hw))
    assert (got > 0).mean() > 0.2            # the court covers the frame
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, jax_out)


def test_emulated_kernel_order_degenerate_thetas(path):
    """|z| <= eps leaves the point unscaled; an all-zero theta maps every
    sample to the template's centre."""
    labels, values, _, out_hw, sample_hw = path
    theta = np.stack([np.eye(3, dtype=F32)] * 2)
    theta[0, 2] = [0.0, 0.0, -1e-9]
    theta[1] = 0.0
    got = _emulate_k1(labels, values, theta, out_hw, sample_hw)
    plain = k1.warp_nearest_plain(torch.from_numpy(labels), torch.from_numpy(theta), out_hw,
                                  torch.from_numpy(values), sample_hw).numpy()
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("wo,ptr,want", [(640, 0, True), (1280, 4096, True), (41, 0, False),
                                         (641, 0, False), (644, 8, False), (644, 16, True)])
def test_k1_vector_route(wo, ptr, want):
    assert k1.vector_route(wo, ptr) is want


# ---- K7-bwd: route and row schedule ------------------------------------------

@pytest.mark.parametrize("dtype,c,ptrs,want", [
    (torch.bfloat16, 64, (0, 256, 512), True),
    (torch.bfloat16, 8, (0, 16, 32), True),
    (torch.bfloat16, 72, (0, 16, 32), True),
    (torch.bfloat16, 1024, (0, 16, 32), True),
    (torch.float32, 64, (0, 16, 32), True),
    (torch.float32, 4, (0, 16, 32), True),
    (torch.bfloat16, 5, (0, 16, 32), False),
    (torch.bfloat16, 33, (0, 16, 32), False),
    (torch.bfloat16, 12, (0, 16, 32), False),     # 16 bytes hold 8 bf16
    (torch.float32, 6, (0, 16, 32), False),
    (torch.bfloat16, 96, (2, 16, 32), False),     # y off the 16-byte grid
    (torch.float32, 96, (0, 20, 32), False),      # g
    (torch.float32, 96, (0, 16, 36), False),      # dx
])
def test_k7bwd_vector_route(dtype, c, ptrs, want):
    assert k7.vector_route(dtype, c, *ptrs) is want


def _check_schedule(m, c, width):
    """Walk the kernels' schedule (csrc/bn_relu_bwd.cu ``place``) and count
    each row's visits."""
    lanes = k7.row_lanes(c, width)
    groups = c // width
    assert lanes == 256 // min(groups, 256) and lanes * min(groups, 256) <= 256
    chunk, blocks = k7.row_schedule(m, lanes)
    assert blocks == (m - 1) // chunk + 1 and chunk % lanes == 0
    seen = np.zeros(m, np.int32)
    longest = 0
    for blk in range(blocks):
        r0 = blk * chunk
        r1 = m if m - r0 < chunk else r0 + chunk
        for lane in range(lanes):
            rows = r1 - r0 - lane
            n = (rows + lanes - 1) // lanes if rows > 0 else 0
            mine = np.arange(r0 + lane, r1, lanes)
            assert len(mine) == n
            seen[mine] += 1
            longest = max(longest, n)
    assert (seen == 1).all()
    assert longest <= 4096
    return blocks, longest


LEVELS = [(360, 640, 64), (180, 320, 128), (90, 160, 256), (45, 80, 512), (22, 40, 1024)]


@pytest.mark.parametrize("batch", [1, 8, 26])
@pytest.mark.parametrize("h,w,c", LEVELS)
@pytest.mark.parametrize("width", [8, 4, 1], ids=["bf16", "f32", "scalar"])
def test_k7bwd_schedule_unet_levels(batch, h, w, c, width):
    blocks, _ = _check_schedule(batch * h * w, c, width)
    assert blocks >= min(500, batch * h * w // 256)    # a few blocks per SM


@pytest.mark.parametrize("m,c,width", [(1, 8, 8), (7, 5, 1), (1000, 72, 8), (3 * 45 * 80, 96, 1),
                                       (4097 * 33 + 5, 33, 1), (2 ** 21 + 3, 2048, 4),
                                       (600_000, 4096, 8)])
def test_k7bwd_schedule_odd_rows(m, c, width):
    _check_schedule(m, c, width)


def test_k7bwd_schedule_caps_the_run():
    """One lane (C = 1024 f32: 256 groups of 4) over 8M rows: the target
    block count alone would give 15,888-row runs; the cap makes more
    blocks."""
    chunk, blocks = k7.row_schedule(8 * 1024 * 1024, k7.row_lanes(1024, 4))
    assert chunk == 4096 and blocks == 2048


# ---- K7-bwd: plain version against JAX in bf16 -------------------------------

def test_bn_relu_bwd_plain_matches_jax_bf16():
    """bf16 y and g at C = 128 (the JAX kernels' lane width): the port's
    plain version and JAX's Pallas kernels (interpret mode) both widen to
    f32, so the sums agree to f32 summation order and dx to one bf16
    rounding."""
    rng = np.random.default_rng(31)
    c = 128
    yb = jnp.asarray((rng.standard_normal((2, 8, 16, c)) * 2 + 0.3).astype(F32), jnp.bfloat16)
    gb = jnp.asarray(rng.standard_normal((2, 8, 16, c)).astype(F32), jnp.bfloat16)
    y32 = np.asarray(yb, F32)
    mean = y32.mean(axis=(0, 1, 2))
    rstd = (1.0 / np.sqrt((y32 * y32).mean(axis=(0, 1, 2)) - mean * mean + 1e-5)).astype(F32)
    gamma = rng.uniform(0.5, 1.5, c).astype(F32)
    beta = (rng.standard_normal(c) * 0.3).astype(F32)
    want = jax_dc._bn_relu_bwd(yb, gb, *map(jnp.asarray, (mean, rstd, gamma, beta)),
                               2 * 8 * 16, interpret=True)
    vecs = [torch.from_numpy(v) for v in (mean, rstd, gamma, beta)]
    got = k7.bn_relu_bwd(torch.from_numpy(y32).bfloat16(),
                         torch.from_numpy(np.asarray(gb, F32)).bfloat16(), *vecs)
    assert got[0].dtype == torch.bfloat16 and want[0].dtype == jnp.bfloat16
    np.testing.assert_allclose(got[0].float().numpy(), np.asarray(want[0], F32),
                               rtol=2e-2, atol=2e-2, err_msg="dy")
    for a, b, tag in zip(got[1:], want[1:], ("dgamma", "dbeta")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=tag)
