"""AOT export / serving round trip (altro_tpu.export).

Build box: define the MPC problem, export the fully-lowered batched MPC
step to a portable artifact file. Serving box: load the artifact (no
problem definition needed — the solver is frozen into the StableHLO)
and drive a closed loop through it.

Run: python examples/export_serving.py
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from altro_tpu.cones import Cone
from altro_tpu.export import (
    call_exported,
    export_mpc_server,
    load_exported,
    save_exported,
    state_to_arrays,
)
from altro_tpu.io.scotty import synthetic_scotty
from altro_tpu.models.bicycle import bicycle_continuous
from altro_tpu.models.integrators import midpoint
from altro_tpu.options import SolverOptions
from altro_tpu.problem import ConstraintSpec, Problem, lqr_cost_from_reference
from altro_tpu.solver import init_state



def build_artifact(path: str):
    """The build box: freeze problem + options into an exported artifact."""
    dtype = jnp.float32
    N, n, m = 20, 4, 2
    ref = synthetic_scotty(N=200)
    cost = lqr_cost_from_reference(
        jnp.full((N + 1, n), 1e-2, dtype), jnp.full((N + 1, m), 1e-3, dtype),
        jnp.asarray(ref.x[: N + 1], dtype), jnp.asarray(ref.u[: N + 1], dtype),
    )
    delta_max = np.deg2rad(60.0)
    steering = ConstraintSpec(
        fn=lambda x, u, k: jnp.stack([x[3] - delta_max, -delta_max - x[3]]),
        cone=Cone.NEGATIVE_ORTHANT, dim=2, active=jnp.ones(N + 1, bool),
        label="steering",
    )
    problem = Problem(
        N=N, n=n, m=m, dynamics=midpoint(bicycle_continuous()), dynamics_jac=None,
        constraints=(steering,), cost=cost,
        h=jnp.full(N, 0.1, dtype), x0=jnp.asarray(ref.x[0], dtype),
    )
    opts = SolverOptions(
        iterations_max=15, use_backtracking_linesearch=True,
        parallel_linesearch=True, ls_try_cubic_first=False,
        penalty_warm_start=True, throw_errors=False,
    )
    # Default platforms=("cuda", "cpu"): one artifact serves on an NVIDIA
    # GPU and falls back to host CPU.
    art = export_mpc_server(problem, opts, batch=None)
    save_exported(art, path)
    return problem, ref


def serve(path: str, problem, ref, ticks: int = 30):
    """The serving box: everything below needs only the artifact file
    (problem/ref are used here just to build inputs and simulate a plant)."""
    srv = load_exported(path)
    print(f"loaded artifact: platforms={srv.platforms}, "
          f"{os.path.getsize(path)} bytes")

    dtype = jnp.float32
    N, m = problem.N, problem.m
    state = state_to_arrays(init_state(problem))
    x = jnp.asarray(ref.x[0], dtype) + 0.02
    dyn = problem.dynamics
    for t in range(ticks):
        x_ref = jnp.asarray(ref.x[t + 1 : t + N + 2], dtype)
        u_ref = jnp.zeros((N + 1, m), dtype)
        u0, state, stats = call_exported(srv, x, x_ref, u_ref, state)
        x = dyn(x, u0, jnp.asarray(0.1, dtype), 0)
        if t % 10 == 0:
            err = float(jnp.linalg.norm(x[:2] - x_ref[1][:2]))
            print(f"tick {t:3d}: iters={int(stats['iterations'])} "
                  f"status={int(stats['status'])} pos_err={err:.4f}")
    print("done: final |u0| =", float(jnp.linalg.norm(u0)))


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "controller.altro")
        problem, ref = build_artifact(path)
        serve(path, problem, ref)
