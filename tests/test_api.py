"""Stateful ALTROSolver facade tests (mirrors reference API usage patterns
from double_integrator_test.cpp / pendulum_test.cpp), plus the surface the
reference declares but never implemented: working input/state bounds,
gain getters, generic costs, populated stats.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from altro_tpu.api import ALL_INDICES, ALTROSolver, LAST_INDEX
from altro_tpu.cones import Cone
from altro_tpu.models.double_integrator import double_integrator_dynamics
from altro_tpu.options import SolverOptions
from altro_tpu.status import AltroError, SolveStatus

N, DIM = 10, 2
NX, NU = 2 * DIM, DIM


def build_solver(x0, penalty_scaling=100.0, penalty_initial=1.0):
    solver = ALTROSolver(N)
    solver.set_dimension(NX, NU)
    solver.set_time_step(0.5)
    solver.set_explicit_dynamics(double_integrator_dynamics(DIM))
    solver.set_lqr_cost(np.ones(NX), np.full(NU, 1e-2), np.zeros(NX), np.zeros(NU), 0, LAST_INDEX)
    solver.set_initial_state(x0)
    solver.set_options(SolverOptions(penalty_initial=penalty_initial,
                                     penalty_scaling=penalty_scaling))
    return solver


def test_goal_constrained_via_api():
    solver = build_solver([1.0, 2.0, 0.0, 0.0])
    xf = jnp.zeros(NX)
    solver.set_constraint(lambda x, u, k: x - xf, NX, Cone.ZERO, "goal", N)
    solver.initialize()
    assert solver.is_initialized()
    status = solver.solve()
    assert status == SolveStatus.SUCCESS
    assert solver.get_iterations() == 3
    assert np.linalg.norm(solver.get_state(N)) < 1e-4
    # Fully-populated stats (reference leaves these stale, SURVEY §2.1)
    assert solver.get_primal_feasibility() < 1e-4
    assert solver.get_stationarity() < 1e-4
    assert np.isfinite(solver.get_final_objective())
    assert solver.get_solve_time_ms() > 0
    # Gain getters (declared-but-missing in the reference)
    assert solver.get_feedback_gain(0).shape == (NU, NX)
    assert solver.get_feedforward_gain(0).shape == (NU,)
    assert solver.get_dual_dynamics(N).shape == (NX,)


def test_input_bounds_via_api():
    """Native bound constraints — equivalent to the hand-written
    inequality cone of double_integrator_test.cpp:294-316."""
    solver = build_solver([2.0, 2.0, 0.0, 0.0], penalty_initial=100.0)
    xf = jnp.zeros(NX)
    solver.set_constraint(lambda x, u, k: x - xf, NX, Cone.ZERO, "goal", N)
    solver.set_input_bounds(u_lo=[-1.0, -1.0], u_hi=[1.0, 1.0])
    solver.initialize()
    status = solver.solve()
    assert status == SolveStatus.SUCCESS
    assert solver.get_iterations() == 5
    np.testing.assert_allclose(solver.get_input(0), [-1.0, -1.0], atol=1e-4)


def test_state_bounds_via_api():
    """Working state bound constraints (stubbed out in the reference,
    knotpoint_data.cpp:721-737): cap the velocity states."""
    solver = build_solver([2.0, 2.0, 0.0, 0.0], penalty_initial=10.0)
    xf = jnp.zeros(NX)
    solver.set_constraint(lambda x, u, k: x - xf, NX, Cone.ZERO, "goal", N)
    v_max = 0.8
    solver.set_state_bounds(
        x_lo=[-np.inf, -np.inf, -v_max, -v_max],
        x_hi=[np.inf, np.inf, v_max, v_max],
    )
    solver.initialize()
    status = solver.solve()
    assert status == SolveStatus.SUCCESS
    xs = np.stack([solver.get_state(k) for k in range(N + 1)])
    assert np.abs(xs[:, 2:]).max() <= v_max + 1e-4
    assert np.linalg.norm(solver.get_state(N)) < 1e-3
    # Constraint-dual getter covers both groups
    assert solver.get_dual_constraint(0, N).shape == (NX,)
    assert solver.get_dual_constraint(1, 3).shape == (2 * NX,)


def test_generic_cost():
    """Working generic costs via autodiff (the reference's SetCostFunction
    drops its callbacks, knotpoint_data.cpp:112-121)."""
    solver = ALTROSolver(N)
    solver.set_dimension(NX, NU)
    solver.set_time_step(0.5)
    solver.set_explicit_dynamics(double_integrator_dynamics(DIM))
    solver.set_cost_function(
        stage=lambda x, u, k: 0.5 * jnp.sum(x * x) + 0.5e-2 * jnp.sum(u * u),
        terminal=lambda x: 0.5 * jnp.sum(x * x),
    )
    solver.set_initial_state([1.0, 2.0, 0.0, 0.0])
    solver.set_options(SolverOptions(iterations_max=10))
    solver.initialize()
    status = solver.solve()
    assert status == SolveStatus.SUCCESS
    # Same problem as the diagonal LQR cost -> same solution family
    assert np.linalg.norm(solver.get_state(N)) < np.linalg.norm([1.0, 2.0, 0.0, 0.0])


def test_quadratic_cost_with_cross_term():
    solver = ALTROSolver(N)
    solver.set_dimension(NX, NU)
    solver.set_time_step(0.5)
    solver.set_explicit_dynamics(double_integrator_dynamics(DIM))
    Q = np.eye(NX)
    R = 1e-2 * np.eye(NU)
    H = np.full((NU, NX), 1e-3)
    solver.set_quadratic_cost(Q, R, H, np.zeros(NX), np.zeros(NU), 0.0, 0, LAST_INDEX)
    solver.set_initial_state([1.0, 2.0, 0.0, 0.0])
    solver.set_options(SolverOptions(iterations_max=10))
    solver.initialize()
    assert solver.solve() == SolveStatus.SUCCESS


def test_mpc_methods():
    solver = build_solver([1.0, 2.0, 0.0, 0.0])
    solver.initialize()
    solver.solve()
    x1 = solver.get_state(1)
    solver.update_linear_costs(q=np.full(NX, 0.1), k_start=0, k_stop=LAST_INDEX)
    solver.set_initial_state(x1)
    solver.shift_trajectory()
    np.testing.assert_allclose(solver.get_state(0), x1, atol=1e-12)
    assert solver.solve() in (SolveStatus.SUCCESS, SolveStatus.MAX_ITERATIONS)


def test_initialize_precondition_order():
    """Preconditions surface in the reference's order (dimension ->
    timestep -> dynamics -> cost; knotpoint_data_test.cpp:71-93)."""
    from altro_tpu.status import ErrorCode

    solver = ALTROSolver(N)
    with pytest.raises(AltroError) as e:
        solver.initialize()
    assert e.value.code == ErrorCode.DIMENSION_UNKNOWN
    solver.set_dimension(NX, NU)
    with pytest.raises(AltroError) as e:
        solver.initialize()
    assert e.value.code == ErrorCode.TIMESTEP_NOT_POSITIVE
    solver.set_time_step(0.1)
    with pytest.raises(AltroError) as e:
        solver.initialize()
    assert e.value.code == ErrorCode.DYNAMICS_FUN_NOT_SET
    solver.set_explicit_dynamics(lambda x, u, h, k: x + h * jnp.concatenate([x[2:], u]))
    with pytest.raises(AltroError) as e:
        solver.initialize()
    assert e.value.code == ErrorCode.COST_FUN_NOT_SET


def test_error_paths():
    solver = ALTROSolver(N)
    with pytest.raises(AltroError):
        solver.initialize()  # no dims/cost
    solver.set_dimension(NX, NU)
    with pytest.raises(AltroError):
        solver.set_time_step(-1.0)
    with pytest.raises(AltroError):
        solver.initialize()  # cost not set
    with pytest.raises(AltroError):
        solver.set_input_bounds(u_lo=[1.0, 1.0], u_hi=[-1.0, -1.0])
    with pytest.raises(AltroError):
        ALTROSolver(0)


def test_range_sentinels():
    solver = ALTROSolver(N)
    solver.set_dimension(NX, NU)
    assert list(solver._range(0, LAST_INDEX, True)) == list(range(N + 1))
    assert list(solver._range(0, LAST_INDEX, False)) == list(range(N))
    assert list(solver._range(ALL_INDICES, 0, True)) == list(range(N + 1))
    assert list(solver._range(3, 0, True)) == [3]
    assert list(solver._range(3, 7, True)) == [3, 4, 5, 6]
    with pytest.raises(AltroError):
        solver._range(N + 1, 0, True)


def test_cost_tolerance_criterion():
    """enable_cost_tolerance implements the reference's intended-but-
    unwired tol_cost stopping rule (solver_options.hpp:20 has no read
    sites): stop with SUCCESS once the accepted-step merit decrease
    falls below tol_cost at a feasible point."""
    opts_base = SolverOptions(
        iterations_max=30, tol_stationarity=0.0, throw_errors=False
    )
    solver = build_solver([1.0, 2.0, 0.0, 0.0])
    solver.set_options(opts_base)
    solver.initialize()
    status_off = solver.solve()
    iters_off = solver.get_iterations()

    solver2 = build_solver([1.0, 2.0, 0.0, 0.0])
    solver2.set_options(opts_base.replace(enable_cost_tolerance=True, tol_cost=1e-10))
    solver2.initialize()
    status_on = solver2.solve()
    iters_on = solver2.get_iterations()

    # stat tolerance 1e-14 is unreachable: without the cost criterion the
    # solve exhausts its budget; with it the plateau stops the solve.
    # exhaustion reports MAX_ITERATIONS, or MERIT_FUN_GRADIENT_TOO_SMALL
    # when the final iteration's plateau gradient sat below
    # tol_meritfun_gradient (the wired reference early-out status)
    assert status_off in (
        SolveStatus.MAX_ITERATIONS,
        SolveStatus.MERIT_FUN_GRADIENT_TOO_SMALL,
    )
    assert status_on == SolveStatus.SUCCESS
    assert iters_on < iters_off
    # and the answers agree (the extra iterations change nothing)
    np.testing.assert_allclose(
        solver.get_input(0), solver2.get_input(0), atol=1e-6
    )


def test_max_solve_time_budget():
    """max_solve_time is enforced host-side via chunked resolves
    (declared but never enforced by the reference)."""
    # Zero budget: first chunk runs, then the clock stops the solve.
    solver = build_solver([1.0, 2.0, 0.0, 0.0])
    xf = jnp.zeros(NX)
    solver.set_constraint(lambda x, u, k: x - xf, NX, Cone.ZERO, "goal", N)
    solver.set_options(SolverOptions(
        iterations_max=200, tol_stationarity=0.0, max_solve_time=0.0,
        throw_errors=False,
    ))
    solver.initialize()
    status = solver.solve()
    assert status == SolveStatus.MAX_SOLVE_TIME
    assert 0 < solver.get_iterations() <= 10  # one chunk
    assert np.isfinite(solver.get_state(N)).all()  # best-so-far kept

    # Generous budget: behaves like the untimed solve (SUCCESS, same answer).
    solver2 = build_solver([1.0, 2.0, 0.0, 0.0])
    solver2.set_constraint(lambda x, u, k: x - xf, NX, Cone.ZERO, "goal", N)
    solver2.set_options(SolverOptions(max_solve_time=120.0))
    solver2.initialize()
    assert solver2.solve() == SolveStatus.SUCCESS
    assert np.linalg.norm(solver2.get_state(N)) < 1e-4


def test_set_tile_dynamics_fast_path_matches_plain():
    """ALTROSolver.set_tile_dynamics: the column-form step for the tiled
    trial-rollout kernel, through the facade + affine input bounds from
    set_input_bounds; the problem becomes kernel-eligible and the
    facade's solve is unchanged."""
    import dataclasses

    from altro_tpu.models.pendulum import pendulum_continuous
    from altro_tpu.models.integrators import midpoint
    from altro_tpu.models.tile_steps import midpoint_cols, pendulum_cols

    N, n, m = 30, 2, 1
    dyn = midpoint(pendulum_continuous())
    opts = SolverOptions(
        iterations_max=12, use_backtracking_linesearch=True,
        parallel_linesearch=True, ls_phase_split=True,
        ls_try_cubic_first=False, ls_armijo_only=True, ls_max_iters=8,
        throw_errors=False)

    def build(with_tile):
        s = ALTROSolver(N)
        s.set_dimension(n, m)
        s.set_time_step(0.06)
        s.set_explicit_dynamics(lambda x, u, h, k: dyn(x, u, h, k))
        s.set_lqr_cost(np.full(n, 1e-1), np.full(m, 1e-3),
                       np.array([np.pi, 0.0]), np.zeros(m))
        s.set_input_bounds(u_lo=[-6.0], u_hi=[6.0])
        s.set_initial_state(np.zeros(n))
        if with_tile:
            s.set_tile_dynamics(midpoint_cols(pendulum_cols()))
        s.initialize()
        s.set_input(np.full((m,), 0.1), 0, N)
        s.set_options(opts)
        return s

    s_plain = build(False)
    s_tile = build(True)
    assert s_tile.problem.dynamics_cols is not None
    # bound setters must have declared the affine fast-path eligibility
    from altro_tpu.ops.pallas_rollout_tiled import rollout_tiled_eligible

    unbatched = dataclasses.replace(
        s_tile.problem,
        constraints=tuple(dataclasses.replace(c, active=False)
                          for c in s_tile.problem.constraints))
    assert rollout_tiled_eligible(s_tile.problem, unbatched)
    assert not rollout_tiled_eligible(s_plain.problem, unbatched)
    st0 = s_plain.solve()
    st1 = s_tile.solve()
    assert st0 == st1
    assert s_plain.get_iterations() == s_tile.get_iterations()
    np.testing.assert_allclose(
        np.asarray(s_plain.state.u), np.asarray(s_tile.state.u), atol=5e-5)
