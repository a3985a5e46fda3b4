"""Multi-device scale-out: shard batched solves over a device mesh.

Batched MPC solves are embarrassingly parallel across scenario lanes, so
the sharding story is: lay the batch axis over a flat 1-D 'batch' mesh
axis (the GPUs of a host reach each other all to all over NVLink, so the
mesh follows the algorithm alone; across hosts via
jax.distributed.initialize), run whole vmapped solves per device with
`shard_map`, and use collectives only for the aggregate solve
statistics (a `psum`/`pmax` reduction, which XLA hands to NCCL).
Scaling is near-linear by construction — this underpins the
solves/s-per-card north-star metric (BASELINE.json).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from altro_tpu.options import SolverOptions
from altro_tpu.problem import DiagonalCost, Problem
from altro_tpu.solver import solve

__all__ = ["initialize_distributed", "make_mesh", "sharded_tracking_solver"]


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None):
    """Multi-host setup: call once per host before building a mesh.

    Thin wrapper over `jax.distributed.initialize`; pass the coordinator
    address (`host:port`), the process count and this process's id —
    nothing detects them. After this, `make_mesh()` spans all hosts'
    devices and the solver's only cross-host traffic is the
    aggregate-stats reduction — scaling is near-linear by construction.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def make_mesh(n_devices: Optional[int] = None, axis: str = "batch") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def sharded_tracking_solver(
    problem: Problem,
    mesh: Mesh,
    opts: SolverOptions = SolverOptions(),
    axis: str = "batch",
    reduce_stats: bool = True,
):
    """shard_map'd batched tracking solver over a 1-D device mesh.

    Returns a jitted fn (x0: [B, n], q: [B, N+1, n], c: [B, N+1],
    state_batch) -> (u0, state', stats, agg) where B must divide the mesh
    size; each device runs B/n_dev whole solves locally; `agg` is a
    replicated dict of cross-device aggregates (max feasibility /
    stationarity, mean iterations, success count) reduced by collectives.
    """
    if not isinstance(problem.cost, DiagonalCost):
        raise TypeError("sharded_tracking_solver requires a DiagonalCost")

    def one(x0, q, c, state):
        cost = dataclasses.replace(problem.cost, q=q, c=c)
        prob = dataclasses.replace(problem, x0=x0, cost=cost)
        new_state, stats = solve(prob, state, opts)
        return new_state.u[0], new_state, stats

    def local_block(x0, q, c, state):
        u0, new_state, stats = jax.vmap(one)(x0, q, c, state)
        if reduce_stats:
            agg = dict(
                max_feasibility=jax.lax.pmax(jnp.max(stats.primal_feasibility), axis),
                max_stationarity=jax.lax.pmax(jnp.max(stats.stationarity), axis),
                mean_iterations=jax.lax.pmean(
                    jnp.mean(stats.iterations.astype(jnp.float32)), axis
                ),
                num_success=jax.lax.psum(jnp.sum((stats.status == 0).astype(jnp.int32)), axis),
            )
        else:
            agg = {}
        return u0, new_state, stats, agg

    b = P(axis)
    state_spec = jax.tree.map(lambda _: b, _state_struct(problem))
    mapped = jax.shard_map(
        local_block,
        mesh=mesh,
        in_specs=(b, b, b, state_spec),
        out_specs=(b, state_spec, _stats_spec(b), P()),
        # Scan carries inside the solve start as replicated constants and
        # become device-varying; skip the varying-manual-axes check.
        check_vma=False,
    )
    return jax.jit(mapped)


def _state_struct(problem):
    from altro_tpu.solver import init_state

    return init_state(problem)


def _stats_spec(b):
    from altro_tpu.solver import SolveStats

    return SolveStats(*([b] * 12))
