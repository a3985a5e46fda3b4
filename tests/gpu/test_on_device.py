"""On-device (GPU) regression subset.

The correctness suite runs f64 on the CPU, with the GPU kernels in the
Pallas interpreter. These tests compile for the card and run in f32:

    ALTRO_GPU_TESTS=1 python -m pytest tests/gpu -q -n 0

Covers: the device check, both tiled kernels compiled against their
plain XLA twins, one batched closed-loop MPC tick at headline shapes, a
heterogeneous per-knot-dims solve, the tiled quadrotor solve against
vmap(solve), and the verbose (host-callback) solve.
"""

import dataclasses

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

N, n, m = 30, 4, 2


def test_device_is_gpu():
    import jax

    assert jax.devices()[0].platform == "gpu", jax.devices()


@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("nm", [(4, 2), (12, 4)])
def test_tiled_kernel_parity_vs_twin(diag, nm):
    """The backward the card runs at this width (the kernel at n=4, the
    twin at n=12) against the twin at "highest" matmul precision."""
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from altro_tpu.ops import tile_iter as ti

    nn, mm = nm
    args, lux = chip_smoke.backward_case(1024, nn, mm, diag)
    backward, _, _ = chip_smoke.gpu_routes(nn)
    out = jax.jit(lambda *a: backward(*a, lux=lux, diag_cost=diag))(*args)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda *a: ti.riccati_backward_tiled(
            *a, lux=lux, diag_cost=diag))(*args)
    assert bool(jnp.all(out.ok)) and bool(jnp.all(ref.ok))
    for f in ("K", "d", "P", "p"):
        assert chip_smoke.relerr(getattr(out, f), getattr(ref, f)) \
            < chip_smoke.KERNEL_RTOL, f


def _bicycle_problem(jnp):
    from altro_tpu.cones import Cone
    from altro_tpu.io.scotty import load_scotty, synthetic_scotty
    from altro_tpu.models.bicycle import bicycle_continuous
    from altro_tpu.models.integrators import midpoint
    from altro_tpu.problem import ConstraintSpec, Problem, lqr_cost_from_reference

    dtype = jnp.float32
    try:
        ref = load_scotty()
    except FileNotFoundError:
        ref = synthetic_scotty(N=500)
    h = float(np.float32(ref.tf / ref.N))
    cost0 = lqr_cost_from_reference(
        jnp.asarray(np.tile(np.full(n, 1e-2), (N + 1, 1)), dtype),
        jnp.asarray(np.tile(np.full(m, 1e-3), (N + 1, 1)), dtype),
        jnp.asarray(ref.x[: N + 1], dtype),
        jnp.asarray(ref.u[: N + 1], dtype),
    )
    delta_max = 60 * np.pi / 180.0
    steering = ConstraintSpec(
        fn=lambda x, u, k: jnp.stack([x[3] - delta_max, -delta_max - x[3]]),
        cone=Cone.NEGATIVE_ORTHANT, dim=2,
        active=jnp.ones(N + 1, bool), label="steering bound",
        diag_hessian=True,
    )
    problem = Problem(
        N=N, n=n, m=m, dynamics=midpoint(bicycle_continuous()),
        dynamics_jac=None, constraints=(steering,), cost=cost0,
        h=jnp.full(N, h, dtype), x0=jnp.asarray(ref.x[0], dtype),
    )
    return problem, ref


def test_batched_closed_loop_tick():
    """One warm-started batched resolve + shift at headline shapes
    (B = 1024, vmap(solve), phase-split x-only grid search)."""
    import jax
    import jax.numpy as jnp

    from altro_tpu.mpc import shift_trajectory
    from altro_tpu.options import SolverOptions
    from altro_tpu.parallel.batch import batch_init_state
    from altro_tpu.solver import solve
    from altro_tpu.status import SolveStatus

    B = 1024
    problem, ref = _bicycle_problem(jnp)
    opts = SolverOptions(
        iterations_max=10, use_backtracking_linesearch=True,
        tol_stationarity=1e-3, tol_primal_feasibility=1e-3,
        throw_errors=False, penalty_warm_start=True,
        parallel_linesearch=True, ls_phase_split=True, ls_armijo_only=True,
        ls_grid_x_only=True, ls_max_iters=8,
    )
    key = jax.random.PRNGKey(0)
    x0 = jnp.asarray(ref.x[0], jnp.float32)[None, :] + 0.02 * jax.random.normal(
        key, (B, n), jnp.float32)
    states = batch_init_state(problem, B)
    states = dataclasses.replace(
        states,
        u=jnp.tile(jnp.asarray([ref.u[0][0], 0.0], jnp.float32), (B, N, 1)),
        x=jnp.tile(jnp.asarray(ref.x[: N + 1], jnp.float32), (B, 1, 1)),
    )

    @jax.jit
    def tick(x0, states):
        def resolve(x0i, st):
            prob = dataclasses.replace(problem, x0=x0i)
            return solve(prob, st, opts)

        states, stats = jax.vmap(resolve)(x0, states)
        states = jax.vmap(shift_trajectory)(states)
        return states, stats

    states, stats = jax.block_until_ready(tick(x0, states))
    success = float(jnp.mean(stats.status == int(SolveStatus.SUCCESS)))
    assert success > 0.95, f"resolve success {success}"
    assert bool(jnp.all(jnp.isfinite(states.x)))
    assert float(jnp.mean(stats.iterations)) < 5.0


def test_hetero_dims_solve_on_device():
    """Heterogeneous per-knot dims through the public API, f32 on device."""
    import jax.numpy as jnp

    from altro_tpu.api import ALTROSolver
    from altro_tpu.status import SolveStatus

    Nh, H = 10, 0.1

    def dyn_a(x, u, hh, k):
        p, v = x[0], x[1]
        return jnp.stack([p + v * hh + 0.5 * u[0] * hh * hh, v + u[0] * hh])

    def dyn_t(x, u, hh, k):
        p, v = x[0], x[1]
        return jnp.stack(
            [p + v * hh + 0.5 * u[0] * hh * hh, v + u[0] * hh, p * hh])

    def dyn_b(x, u, hh, k):
        p, v, s = x[0], x[1], x[2]
        return jnp.stack(
            [p + v * hh + 0.5 * u[0] * hh * hh,
             v + (u[0] - u[1] * v) * hh, s + p * hh])

    s = ALTROSolver(Nh)
    s.set_dimension(2, 1, 0, 5)
    s.set_dimension(3, 2, 5, Nh + 1)
    s.set_time_step(H)
    s.set_explicit_dynamics(dyn_a, k_start=0, k_stop=4)
    s.set_explicit_dynamics(dyn_t, k_start=4, k_stop=5)
    s.set_explicit_dynamics(dyn_b, k_start=5, k_stop=Nh)
    s.set_lqr_cost([1.0, 1.0], [0.1], [1.0, 0.0], [0.0], 0, 5)
    s.set_lqr_cost([1.0, 1.0, 0.5], [0.1, 0.1], [1.0, 0.0, 0.0],
                   [0.0, 0.0], 5, Nh + 1)
    s.set_initial_state([0.0, 0.0])
    s.initialize()
    s.solve()
    assert s.get_status() == SolveStatus.SUCCESS
    xN = np.asarray(s.get_state(Nh))
    # f64 CPU golden for this problem (x64 API run in this repo):
    # xN = [0.24266399, 0.18839072, 0.09557635]
    np.testing.assert_allclose(
        xN, [0.24266399, 0.18839072, 0.09557635], atol=2e-4)


def test_tiled_solve_quadrotor_parity_on_device():
    """n=12/m=4 tiled solve (the XLA twins: n > 4) vs vmap(solve) on the
    card (the quadrotor waypoint bench path)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from altro_tpu import tile_solver
    from altro_tpu.models.integrators import rk4
    from altro_tpu.models.quadrotor import quadrotor_continuous
    from altro_tpu.options import SolverOptions
    from altro_tpu.parallel.batch import batch_init_state
    from altro_tpu.problem import Problem, lqr_cost_from_reference
    from altro_tpu.solver import solve

    B, Nq, nq, mq = 1024, 10, 12, 4
    hover = 0.5 * 9.81 / 4.0
    xf = np.zeros(nq)
    xf[:3] = [1.0, 0.0, 1.0]
    Qd = np.tile(np.concatenate(
        [np.full(3, 1.0), np.full(3, 0.1), np.full(6, 0.1)]), (Nq + 1, 1))
    problem = Problem(
        N=Nq, n=nq, m=mq, dynamics=rk4(quadrotor_continuous()),
        dynamics_jac=None, constraints=(),
        cost=lqr_cost_from_reference(
            jnp.asarray(Qd, jnp.float32), jnp.full((Nq + 1, mq), 1e-2, jnp.float32),
            jnp.asarray(np.tile(xf, (Nq + 1, 1)), jnp.float32),
            jnp.full((Nq + 1, mq), hover, jnp.float32),
        ),
        h=jnp.full(Nq, 0.05, jnp.float32), x0=jnp.zeros(nq, jnp.float32),
    )
    rng = np.random.default_rng(2)
    x0b = jnp.asarray(0.05 * rng.standard_normal((B, nq)), jnp.float32)
    states = batch_init_state(problem, B)
    states = dataclasses.replace(states, u=jnp.full((B, Nq, mq), hover, jnp.float32))
    opts = SolverOptions(
        iterations_max=3, tol_stationarity=1e-3, tol_primal_feasibility=1e-3,
        throw_errors=False, use_backtracking_linesearch=True,
        penalty_warm_start=True, parallel_linesearch=True, ls_phase_split=True,
        ls_armijo_only=True, ls_grid_x_only=True, ls_max_iters=8,
        tol_stationarity_rel=1e-5,
    )

    def resolve(x0i, st):
        return solve(dataclasses.replace(problem, x0=x0i), st, opts)

    sv, tv = jax.jit(jax.vmap(resolve))(x0b, states)

    prob_t = dataclasses.replace(problem, x0=tile_solver.batch_to_tiles(x0b))
    prob_axes = dataclasses.replace(
        problem,
        cost=dataclasses.replace(problem.cost, Q=False, R=False, q=False,
                                 r=False, c=False),
        h=False, x0=True, A=False, B=False, f_aff=False, constraints=(),
    )
    st_t, tt_t = jax.jit(
        lambda s: tile_solver.solve_tiled(prob_t, prob_axes, s, opts)
    )(tile_solver.state_to_tiles(states))
    st = tile_solver.state_from_tiles(st_t)
    tt = tile_solver.stats_from_tiles(tt_t)

    du = jnp.max(jnp.abs(sv.u - st.u).reshape(B, -1), axis=1)
    frac = float(jnp.mean((du < 2e-3).astype(jnp.float32)))
    assert frac > 0.999, f"u agreement {frac}"
    agree = float(jnp.mean((tv.iterations == tt.iterations).astype(jnp.float32)))
    assert agree > 0.99, f"iterations agreement {agree}"


def test_batched_tiled_rollout_kernel_parity_on_device():
    """The tiled trial-rollout kernel (ops/pallas_rollout_tiled.py)
    compiled for the card matches the tiled XLA scan grid at one lane
    tile, with an active affine bound, nonzero duals and per-lane
    penalties, along stabilizing gains (the kernel's and XLA's
    transcendentals differ in the last ulps, which 30 knots amplify)."""
    import jax.numpy as jnp

    from altro_tpu.cones import Cone
    from altro_tpu.io.scotty import load_scotty, synthetic_scotty
    from altro_tpu.models.bicycle import bicycle_continuous
    from altro_tpu.models.integrators import midpoint
    from altro_tpu.models.tile_steps import bicycle_cols, midpoint_cols
    from altro_tpu.ops import tile_iter as ti
    from altro_tpu.ops.tiles import batch_to_tiles
    from altro_tpu.ops.pallas_rollout_tiled import rollout_grid_pallas_tiled
    from altro_tpu.problem import (
        ConstraintSpec,
        Problem,
        lqr_cost_from_reference,
    )
    from altro_tpu.solver import _cost_expansions_and_cost, dynamics_expansions
    from altro_tpu.tvlqr import tvlqr_backward

    Nl, B = 30, 1024
    try:
        ref = load_scotty()
    except FileNotFoundError:
        ref = synthetic_scotty(N=500)
    cost = lqr_cost_from_reference(
        jnp.full((Nl + 1, 4), 1e-2, jnp.float32),
        jnp.full((Nl + 1, 2), 1e-3, jnp.float32),
        jnp.asarray(ref.x[: Nl + 1], jnp.float32),
        jnp.asarray(ref.u[: Nl + 1], jnp.float32))
    rng = np.random.default_rng(9)
    xref = jnp.asarray(ref.x[: Nl + 1], jnp.float32)
    uref = jnp.asarray(ref.u[:Nl] + 0.01 * rng.standard_normal((Nl, 2)),
                       jnp.float32)
    h = jnp.full((Nl,), float(np.float32(ref.tf / ref.N)), jnp.float32)
    steering = ConstraintSpec(
        fn=lambda x, u, k: jnp.stack([x[3] - 0.01, -0.01 - x[3]]),
        cone=Cone.NEGATIVE_ORTHANT, dim=2,
        active=jnp.ones(Nl + 1, bool), label="steering",
        diag_hessian=True, affine=True)
    problem = Problem(
        N=Nl, n=4, m=2, dynamics=midpoint(bicycle_continuous()),
        dynamics_jac=None, constraints=(steering,), cost=cost, h=h,
        x0=jnp.asarray(ref.x[0], jnp.float32),
        dynamics_cols=midpoint_cols(bicycle_cols()))
    z1 = (jnp.asarray(0.1 * rng.standard_normal((Nl + 1, 2)), jnp.float32),)
    rho1 = jnp.asarray(2.5, jnp.float32)
    xfull = jnp.concatenate([xref[:Nl], xref[Nl][None]], axis=0)
    lx, lu, lxx, luu, lux, _ = _cost_expansions_and_cost(
        problem, xfull, uref, z1, rho1)
    A, Bm = dynamics_expansions(problem, xfull, uref)
    g = tvlqr_backward(A, Bm, jnp.zeros_like(lx[:Nl]), lxx, luu, lux,
                       lx, lu, reg=0.0, symmetrize=True)
    alphas = jnp.asarray([1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125,
                          0.015625, 0.0078125], jnp.float32)

    # batch: tile the single-lane fixture with per-lane x0/dual jitter
    x_t = batch_to_tiles(jnp.broadcast_to(xfull, (B,) + xfull.shape))
    u_t = batch_to_tiles(jnp.broadcast_to(uref, (B,) + uref.shape))
    K_t = batch_to_tiles(jnp.broadcast_to(g.K, (B,) + g.K.shape))
    d_t = batch_to_tiles(jnp.broadcast_to(g.d, (B,) + g.d.shape))
    zb = jnp.asarray(
        np.abs(rng.standard_normal((B, Nl + 1, 2))), jnp.float32)
    z_t = (batch_to_tiles(zb),)
    rho_t = batch_to_tiles(
        jnp.asarray(1.0 + 4.0 * rng.random((B, 1)), jnp.float32))[:, 0]
    x0b = jnp.asarray(
        np.asarray(ref.x[0])[None] + 0.01 * rng.standard_normal((B, 4)),
        jnp.float32)
    x0_t = batch_to_tiles(x0b)

    prob_axes = dataclasses.replace(
        problem,
        cost=dataclasses.replace(cost, Q=False, R=False, q=False, r=False,
                                 c=False),
        h=False, x0=True, A=False, B=False, f_aff=False,
        constraints=(dataclasses.replace(steering, active=False),))
    problem_t = dataclasses.replace(problem, x0=x0_t)
    ta = ti.TileArgs(problem_t, prob_axes, (True,))

    import jax

    phi_s, xs_s = jax.jit(
        lambda: ti.rollout_grid_tiled(
            ta, x_t, u_t, K_t, d_t, z_t, rho_t, alphas, x0_t))()
    phi_k, xs_k = jax.jit(
        lambda: rollout_grid_pallas_tiled(
            ta, x_t, u_t, K_t, d_t, z_t, rho_t, alphas, x0_t))()
    scale = float(jnp.max(jnp.abs(phi_s)))
    assert float(jnp.max(jnp.abs(phi_k - phi_s))) < 2e-3 * max(scale, 1.0)
    assert float(jnp.max(jnp.abs(xs_k - xs_s))) < 2e-3


def test_verbose_solve_prints_on_device(capsys):
    """Verbosity.INNER on the card: the in-jit host callbacks print and
    the solve succeeds (in-process: one JAX process per card)."""
    import jax
    import jax.numpy as jnp

    from altro_tpu import ALTROSolver, SolverOptions, Verbosity
    from altro_tpu.models import midpoint, pendulum_continuous
    from altro_tpu.status import SolveStatus

    Np = 50
    s = ALTROSolver(Np)
    s.set_dimension(2, 1)
    s.set_time_step(3.0 / Np)
    s.set_explicit_dynamics(midpoint(pendulum_continuous()))
    s.set_lqr_cost(np.full(2, 1e-2), np.full(1, 1e-3), [np.pi, 0.0], [0.0],
                   0, Np)
    s.set_lqr_cost(np.ones(2), np.full(1, 1e-3), [np.pi, 0.0], [0.0], Np)
    s.set_initial_state([0.0, 0.0])
    s.set_options(SolverOptions(iterations_max=20, verbose=Verbosity.INNER))
    s.initialize()
    s.set_input([0.1])
    assert s.solve() == SolveStatus.SUCCESS
    jax.effects_barrier()
    assert "iter = " in capsys.readouterr().out
