"""The batched model kernels' launch geometry and their plain versions at
the kernels' edges, on the CPU.

- (a) ``ops/logistic.py::plan_logistic`` and ``ops/quadform.py::
  plan_quadform``, the Python half of ``csrc/logistic_logp_grad.cu`` and
  ``csrc/quadform_logp_grad.cu``'s launches: for every ``n <= 256`` and
  row counts up to 10^5, shared memory within what a block may use, a
  grid that covers the chains, at least one stage, and each row tile's
  TMA copies (:func:`_tile_copies`, the kernel's ``issue`` and plain
  loads written out again) 16-byte aligned in global and shared address
  and in size, with the plain loads taking exactly the rest of the tile.
- (b) the plain versions against the Pallas kernels in interpret mode at
  the shapes that reach those edges: the precision at n = 256 (eight
  32-row tiles through six stages on the card) and a design of an odd
  row count with the intercept (y off 16-byte alignment), with
  ``tests/test_ops.py``'s tolerances.

The kernels themselves run on the card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from littlemcmc_tpu import models as jm
from littlemcmc_tpu.ops import quadform_logp_grad
from littlemcmc_tpu.ops.logistic_pallas import make_logistic_logp_grad
from littlemcmc_torch.ops import logistic as tlog
from littlemcmc_torch.ops import quadform as tqf
from littlemcmc_torch.ops._tma import BARRIER_BYTES, MAX_SMEM_BYTES

# row counts: one tile, the row tiles' edges, BASELINE config 4's 1000 and
# 1001, and up to 10^5
_ROWS = (1, 2, 3, 5, 31, 32, 33, 63, 64, 65, 127, 129, 255, 256, 257, 511, 1000, 1001,
         4099, 65_537, 99_999, 100_000)


def _tile_copies(plan, n, rows, t):
    """Row tile ``t``'s bulk copies as ``csrc/logistic_logp_grad.cu``
    issues them, ``(global byte offset into the packed constants,
    shared-memory byte offset, bytes)`` for Xb and then y, and the float
    ranges ``(start, end)`` of the packed constants it loads plainly
    instead."""
    ldx, r = n | 1, plan.row_tile
    r0, m = t * r, min(r, rows - t * r)
    s = t % plan.stages
    xs0 = BARRIER_BYTES + 4 * s * r * ldx
    ys0 = BARRIER_BYTES + 4 * (plan.stages * r * ldx + s * (r + 4) + (4 - plan.y_head) % 4)
    xn = m * ldx & ~3
    yh = min(plan.y_head, m)
    yn = (m - yh) & ~3
    y0 = rows * ldx + r0
    bulk = [(4 * r0 * ldx, xs0, 4 * xn), (4 * (y0 + yh), ys0 + 4 * yh, 4 * yn)]
    plain = [(r0 * ldx + xn, (r0 + m) * ldx), (y0, y0 + yh), (y0 + yh + yn, y0 + m)]
    return bulk, plain


def _check_tile_copies(plan, n, rows, t):
    """Tile ``t``'s bulk copies aligned and the plain loads the rest."""
    bulk, plain = _tile_copies(plan, n, rows, t)
    for src, dst, nbytes in bulk:
        if nbytes:
            assert src % 16 == 0 and dst % 16 == 0 and nbytes % 16 == 0, (n, rows, t, bulk)
        assert nbytes >= 0 and dst + nbytes <= plan.smem_bytes
    ldx, r = n | 1, plan.row_tile
    r0, m = t * r, min(r, rows - t * r)
    (x_src, _, x_bytes), (y_src, _, y_bytes) = bulk
    (xp0, xp1), (yh0, yh1), (yt0, yt1) = plain
    # Xb: the copy then the plain tail, back to back over the tile's rows
    assert x_src == 4 * r0 * ldx and x_src + x_bytes == 4 * xp0 and xp1 == (r0 + m) * ldx
    # y: the plain head, the copy, the plain tail
    y0 = rows * ldx + r0
    assert yh0 == y0 and 4 * yh1 == y_src and y_src + y_bytes == 4 * yt0 and yt1 == y0 + m
    assert yh1 - yh0 <= 3 and xp1 - xp0 <= 3 and yt1 - yt0 <= 3


@pytest.mark.parametrize("C", [1, 1023, 1024])
def test_logistic_plan_fits_and_aligns(C):
    """(a) Every ``n <= 256`` and row count of ``_ROWS`` at ``C`` chains:
    the geometry fits a block, covers the chains, has a stage, gives each
    logit thread at least one chain, and each row tile (the first two, the
    last, and the first to reuse a stage) copies aligned."""
    tc = tlog.CHAIN_TILE
    for n in range(1, 257):
        for rows in _ROWS:
            plan = tlog.plan_logistic(C, n, rows)
            assert plan.smem_bytes <= MAX_SMEM_BYTES
            assert plan.grid * tc >= C > (plan.grid - 1) * tc
            assert plan.stages >= 1 and plan.row_tile * tc >= 256
            assert plan.row_tile % 32 == 0
            tiles = -(-rows // plan.row_tile)
            assert plan.stages <= tiles and (plan.stages >= 2 or tiles == 1)
            assert (4 * (rows * (n | 1) + plan.y_head)) % 16 == 0 and plan.y_head < 4
            for t in sorted({0, 1, plan.stages, tiles - 1} & set(range(tiles))):
                _check_tile_copies(plan, n, rows, t)


def test_logistic_plan_at_the_main_path():
    """(a) BASELINE config 4 at 1024 chains: 128 blocks of 8 chains, the
    whole 1000 x 25 design in flight at once (4 stages of 256 rows)."""
    plan = tlog.plan_logistic(1024, 25, 1000)
    assert tlog.CHAIN_TILE == 8
    assert plan == tlog.LogisticPlan(256, 4, 0, plan.smem_bytes, 128)
    assert plan.stages * plan.row_tile >= 1000
    assert tlog.plan_logistic(1024, 25, 1001).y_head == 3  # y at float 25,025
    with pytest.raises(ValueError, match="geometry"):
        tlog.plan_logistic(1024, 257, 1000)


@pytest.mark.parametrize("C", [1, 1023, 1024])
def test_quadform_plan_fits_and_aligns(C):
    """(a) Every ``n <= 256`` at ``C`` chains: the geometry fits a block,
    covers the chains, has a stage; a precision of more than one tile
    comes in tiles of a multiple of 4 rows (16-byte aligned starts and
    sizes), and the ring holds the whole precision up to n = 224."""
    tc = tqf.CHAIN_TILE
    for n in range(1, 257):
        for aligned in (True, False):
            plan = tqf.plan_quadform(C, n, aligned)
            assert plan.q_bulk == int(aligned)
            assert plan.smem_bytes <= MAX_SMEM_BYTES
            assert plan.grid * tc >= C > (plan.grid - 1) * tc
            assert plan.stages >= 1
            tiles = -(-n // plan.row_tile)
            assert plan.stages <= tiles
            if tiles > 1:
                assert plan.row_tile % 4 == 0 and (plan.row_tile * n) % 4 == 0
            # the block's q rows start 16-byte aligned in q
            assert (tc * n) % 4 == 0
        if n <= 224:
            assert plan.stages * plan.row_tile >= n, n
    assert tqf.plan_quadform(C, 256).stages < 8  # the ring cycles at n = 256


def test_quadform_plain_matches_pallas_kernel_at_256():
    """(b) ``quadform_logp_grad`` in interpret mode at n = 256 (the card's
    ring cycles there) against the plain version, ``tests/test_ops.py``'s
    tolerances."""
    jmodel = jm.CorrelatedGaussian(256, rho=0.6, scale_range=(0.5, 2.0))
    prec = jmodel.prec.astype(np.float32)
    q = np.random.RandomState(256).randn(9, 256).astype(np.float32)
    lp, g = (np.asarray(x) for x in quadform_logp_grad(jnp.asarray(q), jnp.asarray(prec)))
    tlp, tg = tqf.quadform_logp_grad_plain(torch.from_numpy(q), torch.from_numpy(prec))
    np.testing.assert_allclose(tlp.numpy(), lp, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(tg.numpy(), g, rtol=2e-4, atol=1e-4)


def test_logistic_plain_matches_pallas_kernel_at_odd_rows():
    """(b) ``make_logistic_logp_grad`` in interpret mode on a 129 x 25
    design with the intercept (129 x 25 floats put y off 16-byte
    alignment in the packed layout: ``y_head`` 3) against the plain
    version, ``tests/test_ops.py``'s tolerances."""
    X, y = jm.german_credit_synthetic(129, 24)
    xb = np.concatenate([np.ones((129, 1)), X], axis=1)
    q = (np.random.RandomState(129).randn(7, 25) * 0.3).astype(np.float32)
    lp, g = (np.asarray(x) for x in make_logistic_logp_grad(xb, y, 5.0)(jnp.asarray(q)))
    args = (torch.from_numpy(xb.astype(np.float32)), torch.from_numpy(y.astype(np.float32)),
            torch.tensor([1.0 / 25.0]))
    tlp, tg = tlog.logistic_logp_grad_plain(torch.from_numpy(q), *args)
    np.testing.assert_allclose(tlp.numpy(), lp, rtol=3e-4, atol=1e-2)
    np.testing.assert_allclose(tg.numpy(), g, rtol=3e-4, atol=1e-3)
    assert tlog.plan_logistic(7, 25, 129).y_head == 3
