"""Batched tiled trial-rollout GPU kernel vs the XLA scan grid.

The kernel (ops/pallas_rollout_tiled.py, Pallas through Triton) must
reproduce ops/tile_iter.rollout_grid_tiled — phi and the rolled-out
state stacks — to f32 roundoff, including active affine
NEGATIVE_ORTHANT constraint groups with nonzero duals and per-lane
penalties, and end-to-end through solve_tiled. Runs in the Pallas
interpreter on CPU; the compiled kernel is checked on the card by
chip_smoke.py and tests/gpu.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from altro_tpu import tile_solver
from altro_tpu.cones import Cone
from altro_tpu.models.bicycle import bicycle_continuous
from altro_tpu.models.integrators import midpoint
from altro_tpu.models.tile_steps import bicycle_cols, midpoint_cols
from altro_tpu.ops import tile_iter as ti
from altro_tpu.ops.tiles import batch_to_tiles
from altro_tpu.ops import pallas_rollout_tiled as prt
from altro_tpu.ops.pallas_rollout_tiled import (
    rollout_grid_pallas_tiled,
    rollout_tiled_eligible,
)
from altro_tpu.options import SolverOptions
from altro_tpu.parallel.batch import batch_init_state
from altro_tpu.problem import ConstraintSpec, Problem, lqr_cost_from_reference

B = 1024  # one lane tile
N, n, m = 6, 4, 2
DT = jnp.float32
DELTA_MAX = 60 * np.pi / 180.0


def _steering(affine=True):
    return ConstraintSpec(
        fn=lambda x, u, k: jnp.stack([x[3] - DELTA_MAX, -DELTA_MAX - x[3]]),
        cone=Cone.NEGATIVE_ORTHANT, dim=2, active=jnp.ones(N + 1, bool),
        label="steering bound", diag_hessian=True, affine=True,
    )


def _problem(constrained=True, with_cols=True):
    rng = np.random.default_rng(3)
    xref = np.cumsum(0.1 * rng.standard_normal((N + 1, n)), axis=0)
    uref = 0.1 * rng.standard_normal((N + 1, m))
    cost = lqr_cost_from_reference(
        jnp.asarray(np.tile(np.full(n, 1e-2), (N + 1, 1)), DT),
        jnp.asarray(np.tile(np.full(m, 1e-3), (N + 1, 1)), DT),
        jnp.asarray(xref, DT), jnp.asarray(uref, DT),
    )
    return Problem(
        N=N, n=n, m=m, dynamics=midpoint(bicycle_continuous()),
        dynamics_jac=None,
        constraints=(_steering(),) if constrained else (),
        cost=cost, h=jnp.full(N, 0.1, DT),
        x0=jnp.asarray(xref[0], DT),
        dynamics_cols=midpoint_cols(bicycle_cols()) if with_cols else None,
    )


def _tiled_inputs(problem, seed=0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(0.3 * rng.standard_normal((B, N + 1, n)), DT)
    u = jnp.asarray(0.3 * rng.standard_normal((B, N, m)), DT)
    K = jnp.asarray(0.2 * rng.standard_normal((B, N, m, n)), DT)
    d = jnp.asarray(0.2 * rng.standard_normal((B, N, m)), DT)
    # duals: nonnegative with many active entries; per-lane penalties
    z = tuple(
        jnp.asarray(np.abs(rng.standard_normal((B, N + 1, spec.dim))), DT)
        for spec in problem.constraints
    )
    rho = jnp.asarray(1.0 + 9.0 * rng.random((B,)), DT)
    x0 = jnp.asarray(0.3 * rng.standard_normal((B, n)), DT)
    return (batch_to_tiles(x), batch_to_tiles(u), batch_to_tiles(K),
            batch_to_tiles(d), tuple(batch_to_tiles(zj) for zj in z),
            batch_to_tiles(rho[:, None])[:, 0], batch_to_tiles(x0))


def _ta(problem):
    prob_axes = dataclasses.replace(
        problem,
        cost=dataclasses.replace(problem.cost, Q=False, R=False, q=False,
                                 r=False, c=False),
        h=False, x0=True, A=False, B=False, f_aff=False,
        constraints=tuple(dataclasses.replace(s_, active=False)
                          for s_ in problem.constraints),
    )
    z_axes = tuple(True for _ in problem.constraints)
    return ti.TileArgs(problem, prob_axes, z_axes), prob_axes


@pytest.mark.parametrize("constrained", [False, True])
def test_kernel_matches_scan_grid(constrained):
    problem = _problem(constrained=constrained)
    x_t, u_t, K_t, d_t, z_t, rho_t, x0_t = _tiled_inputs(problem)
    ta, prob_axes = _ta(problem)
    # the solver's x0 rides problem.x0 (tiled); the rollout reads the
    # explicit x0 argument — pass the tiled one for both paths
    problem_t = dataclasses.replace(problem, x0=x0_t)
    ta = ti.TileArgs(problem_t, prob_axes, ta.z_axes)
    alphas = jnp.asarray([1.0, 0.5, 0.25, 0.125], DT)

    phi_s, xs_s = ti.rollout_grid_tiled(
        ta, x_t, u_t, K_t, d_t, z_t, rho_t, alphas, x0_t)
    phi_k, xs_k = rollout_grid_pallas_tiled(
        ta, x_t, u_t, K_t, d_t, z_t, rho_t, alphas, x0_t, interpret=True)

    np.testing.assert_allclose(
        np.asarray(phi_k), np.asarray(phi_s), rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(xs_k), np.asarray(xs_s), rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("lanes", [32, 64])
def test_kernel_lane_blocks_match_scan(monkeypatch, lanes):
    """Smaller lane blocks than the default: every program's block index
    maps to its own lanes of the (8, 128) tile."""
    monkeypatch.setattr(prt, "LANES_PER_PROGRAM", lanes)
    problem = _problem(constrained=True)
    x_t, u_t, K_t, d_t, z_t, rho_t, x0_t = _tiled_inputs(problem, seed=5)
    ta, prob_axes = _ta(problem)
    problem_t = dataclasses.replace(problem, x0=x0_t)
    ta = ti.TileArgs(problem_t, prob_axes, ta.z_axes)
    alphas = jnp.asarray([1.0, 0.5], DT)
    phi_s, xs_s = ti.rollout_grid_tiled(
        ta, x_t, u_t, K_t, d_t, z_t, rho_t, alphas, x0_t)
    phi_k, xs_k = rollout_grid_pallas_tiled(
        ta, x_t, u_t, K_t, d_t, z_t, rho_t, alphas, x0_t, interpret=True)
    np.testing.assert_allclose(
        np.asarray(phi_k), np.asarray(phi_s), rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(xs_k), np.asarray(xs_s), rtol=2e-5, atol=1e-5)


def test_kernel_batched_cost_leaves_match_scan():
    """Per-lane (tiled) cost rows and time steps are loaded as lane rows
    instead of shared scalars — same values as the scan grid."""
    problem = _problem(constrained=True)
    x_t, u_t, K_t, d_t, z_t, rho_t, x0_t = _tiled_inputs(problem, seed=2)
    rng = np.random.default_rng(4)

    def lanes(leaf, scale):
        b = np.asarray(leaf)[None] * (1.0 + scale * rng.random(
            (B,) + np.shape(leaf)))
        return batch_to_tiles(jnp.asarray(b, DT))

    cost = problem.cost
    cost_t = dataclasses.replace(cost, Q=lanes(cost.Q, 0.5),
                                 q=lanes(cost.q, 0.5), c=lanes(cost.c, 0.5))
    problem_t = dataclasses.replace(problem, cost=cost_t, x0=x0_t,
                                    h=lanes(problem.h, 0.2))
    _, prob_axes = _ta(problem)
    prob_axes = dataclasses.replace(
        prob_axes, cost=dataclasses.replace(prob_axes.cost, Q=True, q=True,
                                            c=True), h=True)
    ta = ti.TileArgs(problem_t, prob_axes, (True,))
    alphas = jnp.asarray([1.0, 0.25], DT)
    phi_s, xs_s = ti.rollout_grid_tiled(
        ta, x_t, u_t, K_t, d_t, z_t, rho_t, alphas, x0_t)
    phi_k, xs_k = rollout_grid_pallas_tiled(
        ta, x_t, u_t, K_t, d_t, z_t, rho_t, alphas, x0_t, interpret=True)
    np.testing.assert_allclose(
        np.asarray(phi_k), np.asarray(phi_s), rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(xs_k), np.asarray(xs_s), rtol=2e-5, atol=1e-5)


def test_kernel_quadrotor_matches_scan():
    """n=12 / m=4 (RK4 quadrotor, unconstrained) — the register-heavy
    block size."""
    import chip_smoke

    ta, (x, u, K, d, z, rho, alphas, x0) = chip_smoke.rollout_case(
        B, 12, 4, N=3)
    phi_s, xs_s = ti.rollout_grid_tiled(ta, x, u, K, d, z, rho, alphas[:2], x0)
    phi_k, xs_k = rollout_grid_pallas_tiled(
        ta, x, u, K, d, z, rho, alphas[:2], x0, interpret=True)
    np.testing.assert_allclose(
        np.asarray(phi_k), np.asarray(phi_s), rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(xs_k), np.asarray(xs_s), rtol=2e-5, atol=1e-5)


def test_kernel_lowers_for_cuda():
    """The kernel (user dynamics, AL term, shared scalar loads) lowers to
    a Triton call for CUDA from this CPU process."""
    problem = _problem(constrained=True)
    x_t, u_t, K_t, d_t, z_t, rho_t, x0_t = _tiled_inputs(problem)
    ta, prob_axes = _ta(problem)
    ta = ti.TileArgs(dataclasses.replace(problem, x0=x0_t), prob_axes,
                     ta.z_axes)
    alphas = jnp.asarray(0.5 ** np.arange(8), DT)
    text = jax.jit(
        lambda *a: rollout_grid_pallas_tiled(ta, *a)
    ).trace(x_t, u_t, K_t, d_t, z_t, rho_t, alphas, x0_t).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "xla.gpu.triton" in text
    assert "rollout_grid_tiled" in text


def test_eligibility_gates():
    ok = _problem()
    _, prob_axes = _ta(ok)
    assert rollout_tiled_eligible(ok, prob_axes)
    no_cols = _problem(with_cols=False)
    assert not rollout_tiled_eligible(no_cols, prob_axes)
    nonaffine = dataclasses.replace(
        ok,
        constraints=(dataclasses.replace(ok.constraints[0], affine=False),))
    assert not rollout_tiled_eligible(nonaffine, prob_axes)
    soc = dataclasses.replace(
        ok,
        constraints=(dataclasses.replace(
            ok.constraints[0], cone=Cone.SECOND_ORDER),))
    assert not rollout_tiled_eligible(soc, prob_axes)


@pytest.mark.parametrize("rti", [False, True])
def test_solve_tiled_kernel_vs_scan(interpret_kernels, rti):
    """solve_tiled with the rollout kernel (interpret) must track the
    scan-grid solve_tiled per lane — same contract as the tiled-vs-vmap
    parity (f32 tie flips allowed on a tiny lane fraction). Covers both
    the line-search grid and the RTI (W=1 full-step) kernel branch."""
    problem = _problem(constrained=True)
    rng = np.random.default_rng(1)
    x0b = jnp.asarray(
        np.asarray(problem.x0)[None] + 0.05 * rng.standard_normal((B, n)), DT)
    states = batch_init_state(problem, B)
    opts = SolverOptions(
        iterations_max=1 if rti else 3, rti_mode=rti,
        use_backtracking_linesearch=True,
        parallel_linesearch=True, ls_phase_split=True, ls_grid_x_only=True,
        ls_armijo_only=True, ls_max_iters=8, throw_errors=False,
        tol_stationarity=1e-3, tol_primal_feasibility=1e-3,
    )
    prob_t = dataclasses.replace(
        problem, x0=tile_solver.batch_to_tiles(x0b))
    _, prob_axes = _ta(problem)
    st_t = tile_solver.state_to_tiles(states)

    st_k, _ = jax.jit(
        lambda s: tile_solver.solve_tiled(prob_t, prob_axes, s, opts))(st_t)

    prob_scan = dataclasses.replace(prob_t, dynamics_cols=None)
    axes_scan = dataclasses.replace(prob_axes, dynamics_cols=None)
    st_s, _ = jax.jit(
        lambda s: tile_solver.solve_tiled(prob_scan, axes_scan, s, opts))(st_t)

    xk = np.asarray(tile_solver.tiles_to_batch(st_k.x))
    xs = np.asarray(tile_solver.tiles_to_batch(st_s.x))
    lane_err = np.max(np.abs(xk - xs), axis=(1, 2))
    # nearly all lanes bitwise-close; a tiny fraction may flip an
    # Armijo tie under f32 reassociation (the documented tiled contract)
    assert np.mean(lane_err < 1e-4) > 0.99, float(np.mean(lane_err < 1e-4))


def _zoo():
    from altro_tpu.models.double_integrator import double_integrator_dynamics
    from altro_tpu.models.integrators import rk4
    from altro_tpu.models.pendulum import pendulum_continuous
    from altro_tpu.models.quadrotor import quadrotor_continuous
    from altro_tpu.models.tile_steps import (
        double_integrator_cols,
        pendulum_cols,
        quadrotor_cols,
        rk4_cols,
    )

    return {
        "bicycle": (4, 2, midpoint(bicycle_continuous()),
                    midpoint_cols(bicycle_cols())),
        "pendulum": (2, 1, midpoint(pendulum_continuous()),
                     midpoint_cols(pendulum_cols())),
        "double_integrator": (4, 2, double_integrator_dynamics(2),
                              double_integrator_cols(2)),
        "quadrotor": (12, 4, rk4(quadrotor_continuous()),
                      rk4_cols(quadrotor_cols())),
    }


@pytest.mark.parametrize(
    "model", ["bicycle", "pendulum", "double_integrator", "quadrotor"])
def test_column_steps_match_per_lane_dynamics(model):
    """The column-form protocol (dynamics_cols) equals the per-lane
    dynamics component-wise on (8, 128) tiles, for every zoo model."""
    nn, mm, dyn, cols_step = _zoo()[model]
    rng = np.random.default_rng(7)
    x = jnp.asarray(0.5 * rng.standard_normal((nn, 8, 128)), DT)
    u = jnp.asarray(0.5 * rng.standard_normal((mm, 8, 128)), DT)
    if model == "quadrotor":
        u = u + 0.5 * 9.81 / 4
    h = jnp.asarray(0.05, DT)
    cols = cols_step(tuple(x), tuple(u), h)
    got = np.stack([np.asarray(jnp.broadcast_to(c, (8, 128))) for c in cols])
    lane = jax.vmap(jax.vmap(
        lambda xi, ui: dyn(xi, ui, h, 0),
        in_axes=-1, out_axes=-1), in_axes=-1, out_axes=-1)(x, u)
    np.testing.assert_allclose(got, np.asarray(lane), rtol=2e-5, atol=2e-6)
