"""Verbosity tiers: OUTER / INNER / LINE_SEARCH emit their distinct
traces (reference: solver_options.hpp:14 declares the 4 levels;
solver.cpp:438-509 prints the banner + per-iteration line at any
non-silent level; linesearch.cpp:70-73 adds the per-trial trace at
LineSearch)."""

import jax
import jax.numpy as jnp

from altro_tpu.cones import Cone
from altro_tpu.models.double_integrator import double_integrator_dynamics
from altro_tpu.options import SolverOptions, Verbosity
from altro_tpu.problem import ConstraintSpec, DiagonalCost, Problem
from altro_tpu.solver import init_state, solve
from altro_tpu.status import SolveStatus

N, DIM = 10, 2
NX, NU = 2 * DIM, DIM


def make_problem():
    cost = DiagonalCost(
        Q=jnp.ones((N + 1, NX)),
        R=jnp.full((N + 1, NU), 1e-2),
        q=jnp.zeros((N + 1, NX)),
        r=jnp.zeros((N + 1, NU)),
        c=jnp.zeros(N + 1),
    )
    xf = jnp.zeros(NX)
    active = jnp.zeros(N + 1, bool).at[N].set(True)
    goal = ConstraintSpec(
        fn=lambda x, u, k: x - xf, cone=Cone.ZERO, dim=NX, active=active,
        label="goal",
    )
    return Problem(
        N=N, n=NX, m=NU,
        dynamics=double_integrator_dynamics(DIM), dynamics_jac=None,
        constraints=(goal,),
        cost=cost, h=jnp.full(N, 0.5), x0=jnp.asarray([1.0, 1.0, 0.0, 0.0]),
    )


def _run(verbose, capsys, **opt_kw):
    problem = make_problem()
    opts = SolverOptions(verbose=verbose, **opt_kw)
    state, stats = solve(problem, init_state(problem), opts)
    jax.block_until_ready(state)
    jax.effects_barrier()
    assert int(stats.status) == SolveStatus.SUCCESS
    return capsys.readouterr().out


def test_silent_prints_nothing(capsys):
    out = _run(Verbosity.SILENT, capsys)
    assert out == ""


def test_outer_prints_banner_and_dual_rounds_only(capsys):
    out = _run(Verbosity.OUTER, capsys)
    assert "STARTING ALTRO iLQR SOLVE" in out
    assert "ALTRO SOLVE FINISHED" in out
    assert "outer:" in out  # at least one dual/penalty round (goal eq)
    assert "iter = " not in out.replace("outer: iter = ", "")  # no INNER lines
    assert "ls trial" not in out and "ls grid" not in out


def test_inner_prints_per_iteration_line(capsys):
    out = _run(Verbosity.INNER, capsys)
    assert "STARTING ALTRO iLQR SOLVE" in out
    # goal-constrained double integrator converges in exactly 3 iterations
    # (double_integrator_test.cpp:255)
    assert out.count("  iter = ") == 3
    assert "dual update?" in out
    assert "ls trial" not in out and "ls grid" not in out


def test_line_search_level_adds_trial_trace(capsys):
    out = _run(Verbosity.LINE_SEARCH, capsys)
    assert out.count("  iter = ") == 3  # INNER line still present
    assert "Starting Cubic Line Search" in out
    assert "ls trial" in out


def test_line_search_level_traces_parallel_grid(capsys):
    out = _run(
        Verbosity.LINE_SEARCH, capsys,
        use_backtracking_linesearch=True, parallel_linesearch=True,
        ls_phase_split=True, ls_try_cubic_first=False, ls_max_iters=8,
    )
    assert "ls grid block 0" in out
