"""AOT export / serving: serialize a compiled batched MPC step.

The reference ships its solver to embedded targets by packaging sources
for the Arduino toolchain (install/AltroArduinoInstall.cmake,
resources/arduino_package_template/) — "deployment" there means a
self-contained artifact that runs without the development environment.
The JAX equivalent is an ahead-of-time **exported computation**:
`jax.export` serializes the fully-lowered StableHLO of the batched
warm-started MPC step (altro_tpu.mpc.mpc_step vmapped over scenario
lanes) into portable bytes that a serving process deserializes and calls
with zero Python-side tracing/retracing — the solver definition (model,
horizon, constraints, options) is frozen into the artifact.

The exported callable speaks plain arrays only (a dict of ndarrays for
the carried SolverState, no custom pytree types), so the artifact has no
dependency on altro_tpu at load time and is language-portable through
the PJRT C API.

Example
-------
    art = export_mpc_server(problem, opts, batch=1024)
    save_exported(art, "controller.altro")          # build box
    ...
    srv = load_exported("controller.altro")         # serving box
    u0, state, stats = call_exported(
        srv, x_measured, x_ref_window, u_ref_window, state)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import export as jax_export

from altro_tpu.mpc import mpc_step
from altro_tpu.options import SolverOptions
from altro_tpu.problem import Problem
from altro_tpu.solver import SolverState, init_state

__all__ = [
    "state_to_arrays",
    "arrays_to_state",
    "make_serving_fn",
    "export_mpc_server",
    "save_exported",
    "load_exported",
    "call_exported",
]

_STATE_FIELDS = ("x", "u", "y", "rho", "K", "d", "P", "p", "reg")


def state_to_arrays(state: SolverState) -> Dict[str, jnp.ndarray]:
    """Flatten a SolverState into a plain dict of arrays (serving ABI)."""
    out = {f: getattr(state, f) for f in _STATE_FIELDS}
    for j, zj in enumerate(state.z):
        out[f"z{j}"] = zj
    return out


def arrays_to_state(arrays: Dict[str, jnp.ndarray]) -> SolverState:
    """Inverse of state_to_arrays."""
    nz = sum(1 for k in arrays if k.startswith("z") and k[1:].isdigit())
    return SolverState(
        z=tuple(arrays[f"z{j}"] for j in range(nz)),
        **{f: arrays[f] for f in _STATE_FIELDS},
    )


def make_serving_fn(problem: Problem, opts: SolverOptions, batch: Optional[int]):
    """The batched MPC tick as a plain-arrays function.

    (x_measured [B,n], x_ref [B,N+1,n], u_ref [B,N+1,m], state dict)
      -> (u0 [B,m], state' dict, stats dict)

    With batch=None the function is unbatched (single lane, no leading
    B axis) — the low-latency single-controller configuration.
    """

    def one(x_measured, x_ref, u_ref, state_arrays):
        state = arrays_to_state(state_arrays)
        u0, new_state, stats = mpc_step(problem, state, x_measured, x_ref, u_ref, opts)
        return u0, state_to_arrays(new_state), dataclasses.asdict(stats)

    if batch is None:
        return one
    return jax.vmap(one)


def _example_args(problem: Problem, batch: Optional[int]):
    N, n, m = problem.N, problem.n, problem.m
    dt = problem.dtype()
    state = state_to_arrays(init_state(problem))
    x_measured = jnp.zeros((n,), dt)
    x_ref = jnp.zeros((N + 1, n), dt)
    u_ref = jnp.zeros((N + 1, m), dt)
    if batch is not None:
        tile = lambda a: jnp.broadcast_to(a, (batch,) + a.shape)
        state = {k: tile(v) for k, v in state.items()}
        x_measured, x_ref, u_ref = tile(x_measured), tile(x_ref), tile(u_ref)
    return x_measured, x_ref, u_ref, state


def export_mpc_server(
    problem: Problem,
    opts: SolverOptions = SolverOptions(),
    batch: Optional[int] = None,
    platforms: Optional[Sequence[str]] = None,
) -> jax_export.Exported:
    """Lower + export the batched MPC step for the given platforms.

    platforms defaults to ("cuda", "cpu"): one artifact serves on an
    NVIDIA GPU and falls back to host CPU. The problem definition
    (dynamics, horizon, constraints) and SolverOptions are baked in as
    compile-time constants, exactly like the reference's
    statically-sized embedded builds (tvlqr_TotalMemSize sizing,
    tvlqr.cpp:18-63). The exported step is plain XLA (vmap(solve)), so
    it lowers for any platform from any host.
    """
    plats = tuple(platforms) if platforms is not None else ("cuda", "cpu")
    fn = jax.jit(make_serving_fn(problem, opts, batch))
    args = _example_args(problem, batch)
    return jax_export.export(fn, platforms=plats)(*args)


def save_exported(exported: jax_export.Exported, path: str) -> None:
    with open(path, "wb") as f:
        f.write(exported.serialize())


def load_exported(path: str) -> jax_export.Exported:
    with open(path, "rb") as f:
        return jax_export.deserialize(f.read())


def call_exported(
    exported: jax_export.Exported,
    x_measured,
    x_ref,
    u_ref,
    state: Dict[str, jnp.ndarray],
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray], Dict[str, jnp.ndarray]]:
    """One serving call: returns (u0, carried state dict, stats dict)."""
    return exported.call(x_measured, x_ref, u_ref, state)
