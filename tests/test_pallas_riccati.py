"""Tiled batched Riccati backward: the GPU kernel and its plain twin.

The kernel (ops/pallas_riccati.py, Pallas through Triton) runs here in
the Pallas interpreter and must reproduce the plain twin
(ops/tile_iter.riccati_backward_tiled) to f32 roundoff; the twin must
reproduce `jax.vmap(tvlqr_backward)` in f64. The compiled kernel is
checked against the twin on the card by chip_smoke.py and tests/gpu.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from altro_tpu import tile_solver
from altro_tpu.ops import tile_iter as ti
from altro_tpu.ops.pallas_riccati import riccati_backward_pallas_tiled
from altro_tpu.ops.pallas_rollout_tiled import rollout_grid_pallas_tiled
from altro_tpu.ops.tiles import BATCH_TILE, batch_to_tiles, tiles_to_batch
from altro_tpu.tvlqr import tvlqr_backward


def make_batch(Bsz, N, n=4, m=2, seed=0, diag=False, dtype=np.float32):
    """Batch-major operands (A, B, lxx, luu, lux, lx, lu); lux is None and
    lxx/luu are diagonals when diag."""
    rng = np.random.default_rng(seed)
    A = (np.tile(np.eye(n), (Bsz, N, 1, 1))
         + 0.02 * rng.standard_normal((Bsz, N, n, n)))
    B = 0.3 * rng.standard_normal((Bsz, N, n, m))
    if diag:
        lxx = np.abs(rng.standard_normal((Bsz, N + 1, n))) + 0.1
        luu = np.abs(rng.standard_normal((Bsz, N, m))) + 0.1
        lux = None
    else:
        def spd(count, d):
            W = rng.standard_normal((Bsz, count, d, d))
            return np.einsum("bkij,bklj->bkil", W, W) / d + np.eye(d)

        lxx, luu = spd(N + 1, n), spd(N, m)
        lux = 0.02 * rng.standard_normal((Bsz, N, m, n))
    lx = rng.standard_normal((Bsz, N + 1, n))
    lu = rng.standard_normal((Bsz, N, m))
    cast = lambda a: None if a is None else jnp.asarray(a, dtype)
    return tuple(cast(a) for a in (A, B, lxx, luu, lux, lx, lu))


def tiled(A, B, lxx, luu, lux, lx, lu, reg=None):
    """Batch-major operands -> the tiled entry points' arguments."""
    t = lambda a: None if a is None else batch_to_tiles(a)
    if reg is None:
        reg = jnp.zeros((A.shape[0],), A.dtype)
    reg_t = batch_to_tiles(reg[:, None])[:, 0]
    return (t(A), t(B), t(lxx), t(luu), t(lx), t(lu), reg_t), t(lux)


def kernel(args, lux, diag):
    return riccati_backward_pallas_tiled(*args, lux=lux, diag_cost=diag,
                                         interpret=True)


def twin(args, lux, diag):
    return ti.riccati_backward_tiled(*args, lux=lux, diag_cost=diag)


def assert_gains_close(out, ref, rtol=2e-5):
    """Normwise-relative agreement of every gain field, exact flags."""
    for f in ("K", "d", "P", "p", "delta_V"):
        a = np.asarray(getattr(out, f), np.float64)
        b = np.asarray(getattr(ref, f), np.float64)
        assert a.shape == b.shape, f
        scale = max(1.0, float(np.max(np.abs(b))))
        assert float(np.max(np.abs(a - b))) <= rtol * scale, f
    np.testing.assert_array_equal(np.asarray(out.ok), np.asarray(ref.ok))
    np.testing.assert_array_equal(np.asarray(out.fail_index),
                                  np.asarray(ref.fail_index))


@pytest.mark.parametrize(
    "n,m,diag,with_lux",
    [(4, 2, True, False), (4, 2, False, True), (4, 2, False, False),
     (12, 4, True, False), (12, 4, False, True)],
)
def test_kernel_matches_twin(n, m, diag, with_lux):
    """Dense or diagonal cost, with or without the cross-Hessian, at the
    headline's (4, 2) and the quadrotor's (12, 4) blocks."""
    A, B, lxx, luu, lux, lx, lu = make_batch(BATCH_TILE, N=3, n=n, m=m,
                                             diag=diag)
    args, lux_t = tiled(A, B, lxx, luu, lux if with_lux else None, lx, lu)
    out = kernel(args, lux_t, diag)
    ref = twin(args, lux_t, diag)
    assert bool(jnp.all(ref.ok))
    assert_gains_close(out, ref)


@pytest.mark.parametrize("impl", [kernel, twin])
def test_per_lane_reg(impl):
    """A per-lane Quu regularization reaches exactly its own lane."""
    A, B, lxx, luu, lux, lx, lu = make_batch(BATCH_TILE, N=4)
    reg = np.zeros(BATCH_TILE, np.float32)
    reg[7] = 0.5
    args, lux_t = tiled(A, B, lxx, luu, lux, lx, lu, reg=jnp.asarray(reg))
    out = impl(args, lux_t, False)
    K = tiles_to_batch(out.K)
    f0 = jnp.zeros((4, 4), jnp.float32)
    ref_lane = tvlqr_backward(A[7], B[7], f0, lxx[7], luu[7], lux[7], lx[7],
                              lu[7], reg=0.5)
    ref0 = tvlqr_backward(A[7], B[7], f0, lxx[7], luu[7], lux[7], lx[7],
                          lu[7], reg=0.0)
    np.testing.assert_allclose(K[7], np.asarray(ref_lane.K), atol=2e-5)
    np.testing.assert_allclose(K[6], np.asarray(tvlqr_backward(
        A[6], B[6], f0, lxx[6], luu[6], lux[6], lx[6], lu[6]).K), atol=2e-5)
    assert float(jnp.max(jnp.abs(ref_lane.K - ref0.K))) > 1e-3  # reg matters


@pytest.mark.parametrize("impl", [kernel, twin])
def test_per_lane_failure_flags(impl):
    """A lane whose Quu is indefinite at knots 2 and 4 reports
    fail_index 2 (the smallest failing knot) and ok=False; every other
    lane is untouched."""
    A, B, lxx, luu, lux, lx, lu = make_batch(BATCH_TILE, N=6)
    luu = np.asarray(luu).copy()
    luu[3, 2] = -10.0 * np.eye(2)
    luu[3, 4] = -10.0 * np.eye(2)
    args, lux_t = tiled(A, B, lxx, jnp.asarray(luu), lux, lx, lu)
    out = impl(args, lux_t, False)
    ok = np.asarray(tiles_to_batch(out.ok[:, None])[:, 0])
    fail = np.asarray(tiles_to_batch(out.fail_index[:, None])[:, 0])
    assert not ok[3] and fail[3] == 2
    assert ok[[0, 1, 2, 4]].all() and (fail[[0, 1, 2, 4]] == 6).all()
    assert bool(jnp.all(jnp.isfinite(out.K)))


def test_multi_tile_batch():
    """Two lane tiles: every program indexes its own tile, so tile 1
    equals a standalone run of just that tile."""
    ops = make_batch(2 * BATCH_TILE, N=3)
    args, lux_t = tiled(*ops)
    out = kernel(args, lux_t, False)
    assert_gains_close(out, twin(args, lux_t, False))
    solo_args, solo_lux = tiled(*(None if a is None else a[BATCH_TILE:]
                                  for a in ops))
    solo = kernel(solo_args, solo_lux, False)
    np.testing.assert_array_equal(np.asarray(out.K[1:]), np.asarray(solo.K))


@pytest.mark.parametrize("diag,symmetrize",
                         [(False, False), (True, False), (False, True)])
def test_twin_matches_vmapped_scan_f64(diag, symmetrize):
    """The plain twin IS tvlqr_backward per lane (f64, tight)."""
    A, B, lxx, luu, lux, lx, lu = make_batch(BATCH_TILE, N=5, diag=diag,
                                             dtype=np.float64)
    args, lux_t = tiled(A, B, lxx, luu, lux, lx, lu)
    out = ti.riccati_backward_tiled(*args, lux=lux_t, diag_cost=diag,
                                    symmetrize=symmetrize)
    f0 = jnp.zeros(A.shape[:3], A.dtype)
    ref = jax.vmap(lambda *a: tvlqr_backward(*a, symmetrize=symmetrize))(
        A, B, f0, lxx, luu, lux, lx, lu)
    for f in ("K", "d", "P", "p", "delta_V"):
        np.testing.assert_allclose(
            np.asarray(tiles_to_batch(getattr(out, f))),
            np.asarray(getattr(ref, f)), rtol=1e-12, atol=1e-12)
    assert bool(jnp.all(out.ok))


@pytest.mark.parametrize("diag", [True, False])
def test_kernel_lowers_for_cuda(diag):
    """The compiled route: the kernel lowers to a Triton call for CUDA
    from this CPU process (block shapes, loads and the knot loop are all
    accepted by the Triton lowering)."""
    ops = make_batch(BATCH_TILE, N=30, diag=diag)
    args, lux_t = tiled(*ops)
    lowered = jax.jit(
        lambda *a: riccati_backward_pallas_tiled(*a, lux=lux_t, diag_cost=diag)
    ).trace(*args).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "xla.gpu.triton" in text
    assert "riccati_backward_tiled" in text


@pytest.mark.parametrize(
    "platform,dtype,n,expect_kernels",
    [("gpu", jnp.float32, 4, True), ("cpu", jnp.float32, 4, False),
     ("gpu", jnp.float64, 4, False), ("gpu", jnp.float32, 12, False)],
)
def test_kernel_choice_follows_platform(platform, dtype, n, expect_kernels):
    """One rule: the GPU with f32 data and a small state runs the
    kernels, anything else the plain twins."""
    k = tile_solver.select_kernels(platform, dtype, n)
    if expect_kernels:
        assert k.backward is riccati_backward_pallas_tiled
        assert k.rollout is rollout_grid_pallas_tiled
    else:
        assert k.backward is ti.riccati_backward_tiled
        assert k.rollout is ti.rollout_grid_tiled


def test_batch_tile_round_trip():
    x = jnp.arange(2 * BATCH_TILE * 3 * 2, dtype=jnp.float32).reshape(
        2 * BATCH_TILE, 3, 2)
    t = batch_to_tiles(x)
    assert t.shape == (2, 3, 2, 8, 128)
    assert float(t[1, 2, 1, 3, 5]) == float(x[BATCH_TILE + 3 * 128 + 5, 2, 1])
    np.testing.assert_array_equal(np.asarray(tiles_to_batch(t)), np.asarray(x))

