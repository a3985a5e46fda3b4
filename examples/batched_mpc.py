"""Batched receding-horizon MPC: a fleet of bicycle controllers tracking
the Scotty path, vmapped per chip (the BASELINE.json headline workload).

    python examples/batched_mpc.py            # B=64 lanes, 20 ticks
    ALTRO_EXAMPLE_B=1024 python examples/batched_mpc.py
"""

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from altro_tpu.cones import Cone
from altro_tpu.io.scotty import load_scotty, synthetic_scotty
from altro_tpu.models import bicycle_continuous, midpoint
from altro_tpu.options import SolverOptions
from altro_tpu.parallel.batch import batch_init_state, batched_tracking_solver
from altro_tpu.problem import ConstraintSpec, Problem, lqr_cost_from_reference


def main():
    B = int(os.environ.get("ALTRO_EXAMPLE_B", "64"))
    ticks = int(os.environ.get("ALTRO_EXAMPLE_TICKS", "20"))
    dtype = jnp.float32
    N, n, m = 30, 4, 2
    try:
        ref = load_scotty()
    except FileNotFoundError:
        ref = synthetic_scotty()
    h = float(np.float32(ref.tf / ref.N))

    Qd, Rd = np.full(n, 1e-2), np.full(m, 1e-3)
    cost = lqr_cost_from_reference(
        jnp.asarray(np.tile(Qd, (N + 1, 1)), dtype), jnp.asarray(np.tile(Rd, (N + 1, 1)), dtype),
        jnp.asarray(ref.x[: N + 1], dtype), jnp.asarray(ref.u[: N + 1], dtype),
    )
    delta_max = np.deg2rad(60.0)
    steering = ConstraintSpec(
        fn=lambda x, u, k: jnp.stack([x[3] - delta_max, -delta_max - x[3]]),
        cone=Cone.NEGATIVE_ORTHANT, dim=2, active=jnp.ones(N + 1, bool), label="steering",
    )
    dyn = midpoint(bicycle_continuous())
    problem = Problem(
        N=N, n=n, m=m, dynamics=dyn, dynamics_jac=None, constraints=(steering,),
        cost=cost, h=jnp.full(N, h, dtype), x0=jnp.asarray(ref.x[0], dtype),
    )
    opts = SolverOptions(iterations_max=10, use_backtracking_linesearch=True,
                         tol_stationarity=1e-3, tol_primal_feasibility=1e-3,
                         throw_errors=False)
    runner = batched_tracking_solver(problem, opts)

    # Per-lane perturbed fleet
    key = jax.random.PRNGKey(0)
    x_true = jnp.asarray(ref.x[0], dtype)[None] + 0.05 * jax.random.normal(key, (B, n), dtype)
    states = batch_init_state(problem, B)
    states = dataclasses.replace(
        states,
        u=jnp.tile(jnp.asarray([ref.u[0][0], 0.0], dtype), (B, N, 1)),
        x=jnp.tile(jnp.asarray(ref.x[: N + 1], dtype), (B, 1, 1)),
    )

    from altro_tpu.mpc import shift_trajectory

    shift = jax.jit(jax.vmap(shift_trajectory))
    t0 = time.perf_counter()
    for t in range(ticks):
        window = jnp.asarray(ref.x[t : t + N + 1], dtype)
        q = jnp.broadcast_to(-(jnp.asarray(Qd, dtype) * window), (B, N + 1, n))
        c = jnp.broadcast_to(0.5 * jnp.sum(jnp.asarray(Qd, dtype) * window * window, 1), (B, N + 1))
        u0, states, stats = runner(x_true, q, c, states)
        x_true = jax.vmap(lambda x, u: dyn(x, u, h, 0))(x_true, u0)
        states = shift(states)
        if t == 0:
            jax.block_until_ready(u0)
            t0 = time.perf_counter()  # exclude compile
    jax.block_until_ready(u0)
    dt = time.perf_counter() - t0
    err = jnp.linalg.norm(x_true[:, :2] - jnp.asarray(ref.x[ticks][:2], dtype)[None], axis=1)
    print(f"fleet of {B} controllers, {ticks - 1} timed ticks on {jax.devices()[0].platform}")
    print(f"throughput  = {B * (ticks - 1) / dt:.0f} warm resolves/s")
    print(f"mean iters  = {float(jnp.mean(stats.iterations)):.2f}")
    print(f"pos error   = mean {float(err.mean()):.3f} m, max {float(err.max()):.3f} m")


if __name__ == "__main__":
    main()
