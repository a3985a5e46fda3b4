"""solve_tiled (tile-resident batched solve) vs jax.vmap(solve) parity.

The tiled solve must compute the SAME per-lane iterates as vmapping the
per-lane solver with the equivalent options. The tiled side runs the GPU
kernels in the Pallas interpreter (f32) — the kernel path the GPU
headline takes — and, where marked, the plain twins the CPU takes.
Reference loop: SolverImpl::Solve
(/root/reference/src/altro/solver/solver.cpp:414-511).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from altro_tpu import tile_solver
from altro_tpu.cones import Cone
from altro_tpu.io.scotty import load_scotty, synthetic_scotty
from altro_tpu.models.bicycle import bicycle_continuous
from altro_tpu.models.integrators import midpoint
from altro_tpu.options import SolverOptions
from altro_tpu.parallel.batch import batch_init_state
from altro_tpu.problem import ConstraintSpec, Problem, lqr_cost_from_reference
from altro_tpu.solver import solve

B = 1024  # one lane tile
N, n, m = 12, 4, 2
DT = jnp.float32


_SELECT = tile_solver.select_kernels


@pytest.fixture(autouse=True)
def _kernels(interpret_kernels):
    """Every tiled solve here takes the kernel route (interpreted)."""


@pytest.fixture(params=["kernels", "twins"])
def route(request, monkeypatch):
    """Both routes of the tiled solve: the GPU kernels (interpreted) and
    the plain twins the CPU runs."""
    if request.param == "twins":
        monkeypatch.setattr(tile_solver, "select_kernels", _SELECT)
    return request.param


def _problem():
    try:
        ref = load_scotty()
    except FileNotFoundError:
        ref = synthetic_scotty(N=500)
    h = float(np.float32(ref.tf / ref.N))
    cost0 = lqr_cost_from_reference(
        jnp.asarray(np.tile(np.full(n, 1e-2), (N + 1, 1)), DT),
        jnp.asarray(np.tile(np.full(m, 1e-3), (N + 1, 1)), DT),
        jnp.asarray(ref.x[: N + 1], DT),
        jnp.asarray(ref.u[: N + 1], DT),
    )
    delta_max = 60 * np.pi / 180.0
    steering = ConstraintSpec(
        fn=lambda x, u, k: jnp.stack([x[3] - delta_max, -delta_max - x[3]]),
        cone=Cone.NEGATIVE_ORTHANT, dim=2, active=jnp.ones(N + 1, bool),
        label="steering bound", diag_hessian=True,
    )
    problem = Problem(
        N=N, n=n, m=m, dynamics=midpoint(bicycle_continuous()),
        dynamics_jac=None, constraints=(steering,), cost=cost0,
        h=jnp.full(N, h, DT), x0=jnp.asarray(ref.x[0], DT),
    )
    return problem, ref


def _batched_inputs(problem, ref):
    rng = np.random.default_rng(0)
    x0b = jnp.asarray(
        np.tile(ref.x[0], (B, 1)) + 0.05 * rng.standard_normal((B, n)), DT)
    states = batch_init_state(problem, B)
    states = dataclasses.replace(
        states,
        u=jnp.tile(jnp.asarray([ref.u[0][0], 0.0], DT), (B, N, 1)),
        x=jnp.tile(jnp.asarray(ref.x[: N + 1], DT), (B, 1, 1)),
        rho=jnp.full((B,), 1.0, DT),
    )
    return x0b, states


def _opts(**kw):
    base = dict(
        iterations_max=4,
        use_backtracking_linesearch=True,
        tol_stationarity=1e-3,
        tol_primal_feasibility=1e-3,
        throw_errors=False,
        penalty_warm_start=True,
        parallel_linesearch=True,
        ls_phase_split=True,
        ls_armijo_only=True,
        ls_grid_x_only=True,
        ls_max_iters=8,
    )
    base.update(kw)
    return SolverOptions(**base)


def _run_vmapped(problem, x0b, states, opts, ticks=1):
    def resolve(x0i, st):
        prob = dataclasses.replace(problem, x0=x0i)
        return solve(prob, st, opts)

    stats = None
    for _ in range(ticks):
        states, stats = jax.jit(jax.vmap(resolve))(x0b, states)
    return states, stats


def _run_tiled(problem, x0b, states, opts, ticks=1):
    prob_t = dataclasses.replace(
        problem, x0=tile_solver.batch_to_tiles(x0b))
    prob_axes = dataclasses.replace(
        problem,
        cost=dataclasses.replace(problem.cost, Q=False, R=False, q=False,
                                 r=False, c=False),
        h=False, x0=True,
        constraints=tuple(dataclasses.replace(s_, active=False)
                          for s_ in problem.constraints),
        A=False, B=False, f_aff=False,
    )
    st_t = tile_solver.state_to_tiles(states)
    stats_t = None
    run = jax.jit(
        lambda s: tile_solver.solve_tiled(prob_t, prob_axes, s, opts)
    )
    for _ in range(ticks):
        st_t, stats_t = run(st_t)
    return (tile_solver.state_from_tiles(st_t),
            tile_solver.stats_from_tiles(stats_t))


def _assert_state_close(sa, sb, tol=3e-4, lane_frac=1.0):
    """Per-lane agreement: at least `lane_frac` of lanes must match to
    `tol` on every leaf. A lane at an exact Armijo/convergence tie can
    legitimately pick a different trial under f32 reassociation (the two
    paths sum phi in different orders) and then diverge — the contract is
    identical iterates away from such ties, so multi-tick tests use
    lane_frac slightly below 1."""

    def lane_err(a, b):
        d = jnp.abs(a - b)
        return jnp.max(d.reshape(d.shape[0], -1), axis=1)

    for name in ("x", "u", "y", "K", "d", "p", "rho", "reg"):
        err = lane_err(getattr(sa, name), getattr(sb, name))
        frac = float(jnp.mean((err < tol).astype(jnp.float32)))
        assert frac >= lane_frac, f"{name}: frac {frac}, max {float(jnp.max(err))}"
    for za, zb in zip(sa.z, sb.z):
        err = lane_err(za, zb)
        assert float(jnp.mean((err < tol).astype(jnp.float32))) >= lane_frac
    # P entries are O(1/h)-scaled; compare relatively
    errP = lane_err(sa.P, sb.P)
    tolP = tol * max(1.0, float(jnp.max(jnp.abs(sb.P))))
    assert float(jnp.mean((errP < tolP).astype(jnp.float32))) >= lane_frac


def _assert_stats_match(ta, tb, frac=0.999):
    # integer/status stats must match on (nearly) every lane — ties at
    # accept/converge boundaries may flip under f32 reassociation
    for name in ("status", "iterations", "ls_iterations"):
        a, b = getattr(ta, name), getattr(tb, name)
        agree = float(jnp.mean((a == b).astype(jnp.float32)))
        assert agree >= frac, f"{name} agreement {agree}"
    for name in ("merit_value", "alpha", "rho"):
        a, b = getattr(ta, name), getattr(tb, name)
        close = float(jnp.mean((jnp.abs(a - b) < 1e-3).astype(jnp.float32)))
        assert close >= frac, f"{name} close-fraction {close}"


def test_parity_full_solver_two_warm_ticks():
    """Tick 1 must be exact on every lane. On tick 2, warm-started lanes
    sit at Armijo margins of ~1 ulp (phi(alpha) ~ phi0 at convergence), so
    a last-ulp phi difference between summation orders can flip a lane's
    accepted trial — legitimate divergence. The invariant: every lane
    whose state diverges must show a discrete line-search flip
    (ls_iterations/alpha), and statuses/iterations agree everywhere."""
    problem, ref = _problem()
    x0b, states = _batched_inputs(problem, ref)
    opts = _opts()
    sv, tv = _run_vmapped(problem, x0b, states, opts, ticks=1)
    st, tt = _run_tiled(problem, x0b, states, opts, ticks=1)
    _assert_state_close(sv, st)
    _assert_stats_match(tv, tt)

    sv2, tv2 = _run_vmapped(problem, x0b, states, opts, ticks=2)
    st2, tt2 = _run_tiled(problem, x0b, states, opts, ticks=2)
    err = jnp.max(jnp.abs(sv2.x - st2.x).reshape(B, -1), axis=1)
    bad = np.asarray(err > 3e-4)
    flips = np.asarray(
        (tv2.ls_iterations != tt2.ls_iterations)
        | (jnp.abs(tv2.alpha - tt2.alpha) > 1e-6)
        | (tv.ls_iterations != tt.ls_iterations)
        | (jnp.abs(tv.alpha - tt.alpha) > 1e-6)
    )
    assert np.all(flips[bad]), (
        f"{int((~flips[bad]).sum())} divergent lanes without a trial flip")
    assert bad.mean() < 0.10, f"divergent-lane fraction {bad.mean()}"
    for name in ("status", "iterations"):
        agree = float(jnp.mean(
            (getattr(tv2, name) == getattr(tt2, name)).astype(jnp.float32)))
        assert agree >= 0.995, f"{name} agreement {agree}"


def test_parity_rti_mode(route):
    problem, ref = _problem()
    x0b, states = _batched_inputs(problem, ref)
    opts = _opts(rti_mode=True, iterations_max=1, ls_armijo_only=True)
    sv, tv = _run_vmapped(problem, x0b, states, opts)
    st, tt = _run_tiled(problem, x0b, states, opts)
    _assert_state_close(sv, st)
    _assert_stats_match(tv, tt)


def test_parity_diag_expansion():
    """diag_expansion on the tiled path vs the DENSE vmapped reference —
    the diagonal AL Hessian is exactly the dense one here (diagonal cost,
    diag_hessian constraint), so iterates must agree to f32 tolerance."""
    problem, ref = _problem()
    x0b, states = _batched_inputs(problem, ref)
    sv, tv = _run_vmapped(problem, x0b, states, _opts())
    st, tt = _run_tiled(problem, x0b, states, _opts(diag_expansion=True))
    _assert_state_close(sv, st)
    _assert_stats_match(tv, tt)


def test_parity_multiblock_linesearch(route):
    problem, ref = _problem()
    x0b, states = _batched_inputs(problem, ref)
    opts = _opts(ls_max_iters=16)  # 2 blocks of width 8
    sv, tv = _run_vmapped(problem, x0b, states, opts)
    st, tt = _run_tiled(problem, x0b, states, opts)
    _assert_state_close(sv, st)
    _assert_stats_match(tv, tt)


def test_unsupported_options_raise():
    problem, ref = _problem()
    x0b, states = _batched_inputs(problem, ref)
    with pytest.raises(ValueError):
        _run_tiled(problem, x0b, states,
                   SolverOptions(use_backtracking_linesearch=True))


def test_parity_unconstrained_empty_dual_tuple():
    """Empty constraint tuple (the quadrotor waypoint config's shape): the
    tiled dual pytree is (), and feasibility/complementarity reduce over
    nothing. Uses the bicycle model so the interpret-mode kernel stays
    cheap; the full n=12 quadrotor parity runs in the on-device subset
    (tests/tpu/test_on_device.py)."""
    problem, ref = _problem()
    problem = dataclasses.replace(problem, constraints=())
    x0b, states = _batched_inputs(problem, ref)
    states = dataclasses.replace(states, z=())
    opts = _opts(iterations_max=3)
    sv, tv = _run_vmapped(problem, x0b, states, opts)
    st, tt = _run_tiled(problem, x0b, states, opts)
    _assert_state_close(sv, st, tol=1e-3, lane_frac=0.999)
    _assert_stats_match(tv, tt)


def test_parity_recovery_and_best_decrease():
    """ls_failure_recovery + ls_best_decrease_fallback: the tiled solver
    must compute the same per-lane iterates as vmap(solve) with the new
    failure semantics enabled (round-4 success-rate levers)."""
    problem, ref = _problem()
    x0b, states = _batched_inputs(problem, ref)
    opts = _opts(ls_failure_recovery=True, ls_recovery_max_fails=2,
                 ls_best_decrease_fallback=True)
    sv, tv = _run_vmapped(problem, x0b, states, opts, ticks=1)
    st, tt = _run_tiled(problem, x0b, states, opts, ticks=1)
    _assert_state_close(sv, st)
    _assert_stats_match(tv, tt)


def test_parity_divergence_guards_and_fail_index():
    """Round-5 status surface on the tiled path: per-lane
    MAX_OBJECTIVE_EXCEEDED via max_objective_value, and
    SolveStats.bp_fail_index == N on healthy lanes — both matching
    vmap(solve) lane-for-lane."""
    problem, ref = _problem()
    x0b, states = _batched_inputs(problem, ref)
    opts = _opts(max_objective_value=1e-12, tol_stationarity=0.0)
    sv, tv = _run_vmapped(problem, x0b, states, opts)
    st, tt = _run_tiled(problem, x0b, states, opts)
    from altro_tpu.status import SolveStatus

    assert np.all(np.asarray(tv.status) == int(SolveStatus.MAX_OBJECTIVE_EXCEEDED))
    assert np.all(np.asarray(tt.status) == np.asarray(tv.status))
    assert np.all(np.asarray(tt.iterations) == np.asarray(tv.iterations))
    assert np.all(np.asarray(tt.bp_fail_index) == N)
    assert np.all(np.asarray(tv.bp_fail_index) == N)


def test_select_best_tiled_ignores_nonfinite_trials():
    """ADVICE r4: a diverged trial's +inf/NaN phi must not poison the
    best-decrease blend through 0*inf — the best FINITE trial wins."""
    from altro_tpu.ops.tile_iter import select_best_tiled, select_trial_tiled

    W, Bt = 3, 1
    phis = jnp.stack([
        jnp.full((Bt, 8, 128), jnp.inf, jnp.float32),   # alpha=1 overflowed
        jnp.full((Bt, 8, 128), 2.0, jnp.float32),
        jnp.full((Bt, 8, 128), 5.0, jnp.float32),
    ])
    xstacks = jnp.stack([
        jnp.full((Bt, 4, 2, 8, 128), jnp.nan, jnp.float32),
        jnp.full((Bt, 4, 2, 8, 128), 20.0, jnp.float32),
        jnp.full((Bt, 4, 2, 8, 128), 50.0, jnp.float32),
    ])
    alphas = jnp.asarray([1.0, 0.5, 0.25], jnp.float32)
    alpha, phi, xsel = select_best_tiled(alphas, phis, xstacks)
    assert np.all(np.asarray(phi) == 2.0)
    assert np.all(np.asarray(alpha) == 0.5)
    assert np.all(np.asarray(xsel) == 20.0)

    # first-passing selection: trial 0 diverged (fails), trial 1 passes;
    # the selected lane values must be finite
    passes = jnp.stack([
        jnp.zeros((Bt, 8, 128), bool),
        jnp.ones((Bt, 8, 128), bool),
        jnp.ones((Bt, 8, 128), bool),
    ])
    found, idx, alpha2, phi2, xsel2 = select_trial_tiled(
        passes, alphas, phis, xstacks)
    assert bool(jnp.all(found))
    assert np.all(np.asarray(idx) == 1)
    assert np.all(np.asarray(phi2) == 2.0)
    assert np.all(np.asarray(xsel2) == 20.0)
