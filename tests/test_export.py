"""AOT export / serving round-trip tests (altro_tpu/export.py).

The TPU-native analog of the reference's embedded packaging
(install/AltroArduinoInstall.cmake): a serialized, fully-lowered MPC
step artifact that a serving process deserializes and calls without
retracing. Checks the artifact's answers equal the live solver's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from altro_tpu.cones import Cone
from altro_tpu.export import (
    arrays_to_state,
    call_exported,
    export_mpc_server,
    load_exported,
    make_serving_fn,
    save_exported,
    state_to_arrays,
)
from altro_tpu.io.scotty import synthetic_scotty
from altro_tpu.models.bicycle import bicycle_continuous
from altro_tpu.models.integrators import midpoint
from altro_tpu.mpc import mpc_step
from altro_tpu.options import SolverOptions
from altro_tpu.problem import ConstraintSpec, Problem, lqr_cost_from_reference
from altro_tpu.solver import init_state


def _bicycle_problem(N=12):
    dtype = jnp.float64
    ref = synthetic_scotty(N=100)
    n, m = 4, 2
    Qd = np.full((N + 1, n), 1e-2)
    Rd = np.full((N + 1, m), 1e-3)
    cost = lqr_cost_from_reference(
        jnp.asarray(Qd, dtype), jnp.asarray(Rd, dtype),
        jnp.asarray(ref.x[: N + 1], dtype), jnp.asarray(ref.u[: N + 1], dtype),
    )
    delta_max = 60 * np.pi / 180.0
    steering = ConstraintSpec(
        fn=lambda x, u, k: jnp.stack([x[3] - delta_max, -delta_max - x[3]]),
        cone=Cone.NEGATIVE_ORTHANT, dim=2, active=jnp.ones(N + 1, bool),
        label="steering bound",
    )
    problem = Problem(
        N=N, n=n, m=m, dynamics=midpoint(bicycle_continuous()), dynamics_jac=None,
        constraints=(steering,), cost=cost,
        h=jnp.full(N, 0.1, dtype), x0=jnp.asarray(ref.x[0], dtype),
    )
    return problem, ref


def test_state_arrays_round_trip():
    problem, _ = _bicycle_problem()
    state = init_state(problem)
    back = arrays_to_state(state_to_arrays(state))
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_export_round_trip_matches_live_solver(tmp_path):
    problem, ref = _bicycle_problem()
    opts = SolverOptions(
        iterations_max=6, use_backtracking_linesearch=True,
        tol_stationarity=1e-6, tol_primal_feasibility=1e-6, throw_errors=False,
        penalty_warm_start=True,
    )
    N, n = problem.N, problem.n
    dtype = problem.dtype()

    art = export_mpc_server(problem, opts, batch=None, platforms=("cpu",))
    path = str(tmp_path / "controller.altro")
    save_exported(art, path)
    srv = load_exported(path)
    assert srv.platforms == ("cpu",)

    # Drive 5 closed-loop ticks through BOTH paths and compare exactly.
    state_live = init_state(problem)
    state_srv = state_to_arrays(init_state(problem))
    x_meas = jnp.asarray(ref.x[0], dtype) + 0.01
    dyn = problem.dynamics
    for t in range(5):
        x_ref = jnp.asarray(ref.x[t + 1 : t + N + 2], dtype)
        u_ref = jnp.zeros((N + 1, problem.m), dtype)
        u_live, state_live, stats_live = mpc_step(
            problem, state_live, x_meas, x_ref, u_ref, opts
        )
        u_srv, state_srv, stats_srv = call_exported(srv, x_meas, x_ref, u_ref, state_srv)
        np.testing.assert_allclose(np.asarray(u_live), np.asarray(u_srv), rtol=0, atol=1e-8)
        np.testing.assert_array_equal(
            int(stats_live.iterations), int(np.asarray(stats_srv["iterations"]))
        )
        x_meas = dyn(x_meas, u_live, jnp.asarray(0.1, dtype), 0)
    # Carried serving state stays consistent with the live pytree state
    for f in ("x", "u", "rho"):
        np.testing.assert_allclose(
            np.asarray(getattr(state_live, f)), np.asarray(state_srv[f]),
            rtol=0, atol=1e-8,
        )
    assert np.isfinite(np.asarray(u_srv)).all()


def test_export_batched_shapes_and_finiteness(tmp_path):
    problem, ref = _bicycle_problem(N=8)
    opts = SolverOptions(
        iterations_max=3, use_backtracking_linesearch=True, throw_errors=False
    )
    B, n, m, N = 4, problem.n, problem.m, problem.N
    dtype = problem.dtype()
    art = export_mpc_server(problem, opts, batch=B, platforms=("cpu",))
    srv = load_exported(str((lambda p: (save_exported(art, p), p)[1])(str(tmp_path / "b.altro"))))

    tile = lambda a: jnp.broadcast_to(jnp.asarray(a, dtype), (B,) + jnp.asarray(a, dtype).shape)
    state = {k: tile(v) for k, v in state_to_arrays(init_state(problem)).items()}
    x_meas = tile(ref.x[0]) + 0.01 * jnp.arange(B, dtype=dtype)[:, None]
    x_ref = tile(ref.x[1 : N + 2])
    u_ref = tile(jnp.zeros((N + 1, m), dtype))
    u0, state, stats = call_exported(srv, x_meas, x_ref, u_ref, state)
    assert u0.shape == (B, m)
    assert state["x"].shape == (B, N + 1, n)
    assert stats["iterations"].shape == (B,)
    assert np.isfinite(np.asarray(u0)).all()


def test_export_multiplatform_artifact_declares_cuda_and_cpu():
    """The default artifact is cross-lowered for the GPU from this CPU
    process (the exported step is plain XLA, no platform-dependent
    kernel), and it still executes on the CPU backend."""
    problem, _ = _bicycle_problem(N=5)
    opts = SolverOptions(iterations_max=2, use_backtracking_linesearch=True, throw_errors=False)
    art = export_mpc_server(problem, opts, batch=None)  # default ("cuda", "cpu")
    assert set(art.platforms) == {"cuda", "cpu"}
    args = [jnp.zeros((problem.n,), problem.dtype()),
            jnp.zeros((problem.N + 1, problem.n), problem.dtype()),
            jnp.zeros((problem.N + 1, problem.m), problem.dtype()),
            state_to_arrays(init_state(problem))]
    u0, _, _ = call_exported(art, *args)
    assert u0.shape == (problem.m,)


@pytest.mark.parametrize("batch", [None, 4])
def test_cuda_only_export_cross_lowers_on_cpu(batch):
    """A platforms=("cuda",) artifact — what serves on the card — lowers
    from a CPU-only process, single-controller and batched; its
    serialized form round-trips."""
    from jax import export as jax_export

    problem, _ = _bicycle_problem(N=5)
    opts = SolverOptions(iterations_max=2, use_backtracking_linesearch=True,
                         throw_errors=False)
    art = export_mpc_server(problem, opts, batch=batch, platforms=("cuda",))
    assert art.platforms == ("cuda",)
    back = jax_export.deserialize(art.serialize())
    assert back.platforms == ("cuda",)
    assert back.in_avals == art.in_avals

