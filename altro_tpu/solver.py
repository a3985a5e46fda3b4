"""Fused AL-iLQR solve: the jittable solver core.

Redesign of the reference solver engine
(/root/reference/src/altro/solver/solver.cpp:116-511). Structure map:

  reference (serial C++ loops, mutable per-knot workspaces)
    -> here (pure jittable functions over a SolverState pytree):

  * per-knot Calc* loops (solver.cpp:166-201)   -> vmap over the knot axis
  * OpenLoopRollout / MeritFunction rollouts    -> lax.scan carrying
    (x, dx/dalpha, phi, dphi) — the analytic forward-sensitivity merit
    derivative of solver.cpp:273-355, not autodiff through the scan
  * BackwardPass (tvlqr.cpp:65-195)             -> lax.scan Riccati with an
    adaptive Quu regularization retry (the reference's unused `reg` hook)
  * fused outer/inner iteration loop with adaptive dual/penalty triggers
    (solver.cpp:447-502)                        -> bounded lax.while_loop
  * whole-solve abort on failure                -> per-lane int status

`solve` is a pure function (problem, state, options) -> (state', stats):
warm starting an MPC resolve is just calling it again with the carried
state, and batching scenarios is `vmap` over (problem.x0 / cost refs /
state).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from altro_tpu import al
from altro_tpu import cones
from altro_tpu.ops.smallmat import mtv, mv
from altro_tpu.tvlqr import _unroll
from altro_tpu.linesearch import (
    LineSearchOptions,
    parallel_backtracking_search,
    parallel_backtracking_search_split,
    wolfe_line_search,
)
from altro_tpu.options import SolverOptions, Verbosity
from altro_tpu.problem import DiagonalCost, Problem
from altro_tpu.status import LineSearchCode, SolveStatus
from altro_tpu.tvlqr import TVLQRGains, tvlqr_backward, tvlqr_backward_associative

__all__ = ["SolverState", "SolveStats", "init_state", "solve", "open_loop_rollout", "total_cost"]


def _register(cls, data_fields, meta_fields=()):
    jax.tree_util.register_dataclass(cls, data_fields=list(data_fields), meta_fields=list(meta_fields))
    return cls


@dataclasses.dataclass(frozen=True)
class SolverState:
    """Everything that persists across (warm-started) solves.

    Mirrors the reference's KnotPointData persistent slots: trajectory
    (x, u), TVLQR duals y, constraint duals z, penalty rho, gains
    K/d and cost-to-go P/p (knotpoint_data.hpp:160-233) — but stacked
    over the knot axis as one pytree the caller can carry/donate.
    """

    x: jnp.ndarray  # [N+1, n]
    u: jnp.ndarray  # [N, m]
    y: jnp.ndarray  # [N+1, n]
    z: Tuple[jnp.ndarray, ...]  # per-group [N+1, p]
    rho: jnp.ndarray  # scalar penalty
    K: jnp.ndarray  # [N, m, n]
    d: jnp.ndarray  # [N, m]
    P: jnp.ndarray  # [N+1, n, n]
    p: jnp.ndarray  # [N+1, n]
    reg: jnp.ndarray  # scalar Quu regularization in effect


_register(SolverState, ["x", "u", "y", "z", "rho", "K", "d", "P", "p", "reg"])


@dataclasses.dataclass(frozen=True)
class SolveStats:
    """Fully-populated solve statistics (the reference leaves most of its
    AltroStats stale, solver_stats.hpp:14-25 / SURVEY §2.1)."""

    status: jnp.ndarray  # int32 SolveStatus
    iterations: jnp.ndarray  # int32
    objective_value: jnp.ndarray  # original cost (no AL terms)
    merit_value: jnp.ndarray  # phi at last accepted point
    stationarity: jnp.ndarray
    primal_feasibility: jnp.ndarray
    complementarity: jnp.ndarray
    rho: jnp.ndarray
    alpha: jnp.ndarray  # last line-search step
    ls_iterations: jnp.ndarray  # int32, last line search
    dphi: jnp.ndarray
    # Smallest knot index whose Quu factorization failed in the LAST
    # backward pass (N = none failed). The reference reports the failing
    # knot via its error message (tvlqr.cpp:162-164 "BackwardPass failed
    # at index k"); here it is a first-class per-lane stat.
    bp_fail_index: jnp.ndarray  # int32


_register(
    SolveStats,
    [
        "status",
        "iterations",
        "objective_value",
        "merit_value",
        "stationarity",
        "primal_feasibility",
        "complementarity",
        "rho",
        "alpha",
        "ls_iterations",
        "dphi",
        "bp_fail_index",
    ],
)


def init_state(problem: Problem) -> SolverState:
    N, n, m = problem.N, problem.n, problem.m
    dt = problem.x0.dtype
    return SolverState(
        x=jnp.tile(problem.x0, (N + 1, 1)),
        u=jnp.zeros((N, m), dt),
        y=jnp.zeros((N + 1, n), dt),
        z=problem.init_duals(),
        rho=jnp.asarray(1.0, dt),
        K=jnp.zeros((N, m, n), dt),
        d=jnp.zeros((N, m), dt),
        P=jnp.zeros((N + 1, n, n), dt),
        p=jnp.zeros((N + 1, n), dt),
        reg=jnp.asarray(0.0, dt),
    )


# ---------------------------------------------------------------------------
# Rollouts and merit function
# ---------------------------------------------------------------------------


def open_loop_rollout(problem: Problem, u: jnp.ndarray, x0: Optional[jnp.ndarray] = None):
    """x_{k+1} = f(x_k, u_k) from x0. Parity: solver.cpp:116-131."""
    x0 = problem.x0 if x0 is None else x0

    def step(x_k, inp):
        k, u_k = inp
        x_next = problem.dyn_step(k, x_k, u_k)
        return x_next, x_k

    ks = jnp.arange(problem.N, dtype=jnp.int32)
    x_N, x_stack = jax.lax.scan(step, x0, (ks, u), unroll=_unroll(problem.N))
    return jnp.concatenate([x_stack, x_N[None]], axis=0)


class MeritOut(NamedTuple):
    phi: jnp.ndarray
    dphi: jnp.ndarray
    x: jnp.ndarray  # [N+1, n] candidate trajectory
    u: jnp.ndarray  # [N, m]
    y: jnp.ndarray  # [N+1, n] TVLQR dual estimates
    A: jnp.ndarray  # [N, n, n] dynamics expansion at candidate
    B: jnp.ndarray  # [N, n, m]
    lx: jnp.ndarray  # [N+1, n] AL cost gradients at candidate
    lu: jnp.ndarray  # [N, m]
    convals: Tuple[jnp.ndarray, ...]  # per-group [N+1, p]
    zproj: Tuple[jnp.ndarray, ...]  # per-group [N+1, p]


class MeritOutLight(NamedTuple):
    """Rollout-only merit payload (no expansions): what a line-search trial
    needs for acceptance plus what the phase-split completion step needs to
    reconstruct the full `MeritOut` at the one accepted step."""

    phi: jnp.ndarray
    x: jnp.ndarray  # [N+1, n]
    u: jnp.ndarray  # [N, m]
    y: jnp.ndarray  # [N+1, n]
    convals: Tuple[jnp.ndarray, ...]
    zproj: Tuple[jnp.ndarray, ...]


def merit_function(
    problem: Problem,
    ref_x,
    ref_u,
    K,
    d,
    P,
    p,
    z,
    rho,
    alpha,
    x0,
    with_derivative: bool,
) -> MeritOut:
    """Closed-loop rollout + AL cost + analytic dphi/dalpha.

    Parity: solver.cpp:273-355. The rollout tracks the policy
      u = u_ref - K (x - x_ref) + alpha d,
    the dual estimate y = P (x - x_ref) + p, and (when requested) the
    exact directional derivative via the forward sensitivity recurrence
      du/da = -K dx/da + d;  dx/da' = A dx/da + B du/da;
      dphi += lx . dx/da + lu . du/da.
    """
    N, n, m = problem.N, problem.n, problem.m
    dtype = x0.dtype
    alpha = jnp.asarray(alpha, dtype)
    ks = jnp.arange(N, dtype=jnp.int32)
    z_stage = tuple(zj[:N] for zj in z)
    z_term = tuple(zj[N] for zj in z)

    def step(carry, inp):
        x_k, dx_da, phi, dphi = carry
        k, xr, ur, K_k, d_k, P_k, p_k, z_k = inp
        dx = x_k - xr
        du = -mv(K_k, dx) + alpha * d_k
        u_k = ur + du
        y_k = mv(P_k, dx) + p_k
        x_next = problem.dyn_step(k, x_k, u_k)
        cost_k, convals_k, zproj_k = al.al_cost(problem, k, x_k, u_k, z_k, rho, terminal=False)
        phi = phi + cost_k
        if with_derivative:
            A_k, B_k = problem.dyn_expansion(k, x_k, u_k)
            du_da = -mv(K_k, dx_da) + d_k
            dx_da_next = mv(A_k, dx_da) + mv(B_k, du_da)
            lx_k, lu_k = al.al_grad(problem, k, x_k, u_k, z_k, rho, terminal=False)
            dphi = dphi + jnp.dot(lx_k, dx_da) + jnp.dot(lu_k, du_da)
        else:
            A_k = jnp.zeros((n, n), dtype)
            B_k = jnp.zeros((n, m), dtype)
            dx_da_next = dx_da
            lx_k = jnp.zeros((n,), dtype)
            lu_k = jnp.zeros((m,), dtype)
        out = (x_k, u_k, y_k, A_k, B_k, lx_k, lu_k, convals_k, zproj_k)
        return (x_next, dx_da_next, phi, dphi), out

    init = (x0, jnp.zeros((n,), dtype), jnp.asarray(0.0, dtype), jnp.asarray(0.0, dtype))
    xs = (ks, ref_x[:N], ref_u, K, d, P[:N], p[:N], z_stage)
    (x_N, dx_da_N, phi, dphi), outs = jax.lax.scan(step, init, xs, unroll=_unroll(N))
    (x_st, u, y_st, A, B, lx_st, lu, convals_st, zproj_st) = outs

    # Terminal knot point (solver.cpp:318-332)
    cost_N, convals_N, zproj_N = al.al_cost(problem, N, x_N, None, z_term, rho, terminal=True)
    phi = phi + cost_N
    y_N = mv(P[N], x_N - ref_x[N]) + p[N]
    if with_derivative:
        lx_N, _ = al.al_grad(problem, N, x_N, None, z_term, rho, terminal=True)
        dphi = dphi + jnp.dot(lx_N, dx_da_N)
    else:
        lx_N = jnp.zeros((n,), dtype)

    x = jnp.concatenate([x_st, x_N[None]], axis=0)
    y = jnp.concatenate([y_st, y_N[None]], axis=0)
    lx = jnp.concatenate([lx_st, lx_N[None]], axis=0)
    convals = tuple(
        jnp.concatenate([cs, cN[None]], axis=0) for cs, cN in zip(convals_st, convals_N)
    )
    zproj = tuple(
        jnp.concatenate([zs, zN[None]], axis=0) for zs, zN in zip(zproj_st, zproj_N)
    )
    return MeritOut(phi, dphi, x, u, y, A, B, lx, lu, convals, zproj)


def merit_rollout_light(
    problem: Problem, ref_x, ref_u, K, d, P, p, z, rho, alpha, x0
) -> MeritOutLight:
    """Closed-loop rollout + AL cost, WITHOUT the per-step expansion work.

    The dynamics-only half of `merit_function`: no Jacobians, no AL
    gradients, no sensitivity recurrence. Used by the phase-split line
    search (SolverOptions.ls_phase_split), which evaluates every trial
    step with this cheap rollout and reconstructs the full expansion
    payload only at the accepted step (knot-parallel, off the sequential
    chain). phi is bitwise-identical to merit_function's.
    """
    N = problem.N
    dtype = x0.dtype
    alpha = jnp.asarray(alpha, dtype)
    ks = jnp.arange(N, dtype=jnp.int32)
    z_stage = tuple(zj[:N] for zj in z)
    z_term = tuple(zj[N] for zj in z)

    def step(carry, inp):
        x_k, phi = carry
        k, xr, ur, K_k, d_k, P_k, p_k, z_k = inp
        dx = x_k - xr
        u_k = ur - mv(K_k, dx) + alpha * d_k
        y_k = mv(P_k, dx) + p_k
        x_next = problem.dyn_step(k, x_k, u_k)
        cost_k, convals_k, zproj_k = al.al_cost(problem, k, x_k, u_k, z_k, rho, terminal=False)
        return (x_next, phi + cost_k), (x_k, u_k, y_k, convals_k, zproj_k)

    init = (x0, jnp.asarray(0.0, dtype))
    xs = (ks, ref_x[:N], ref_u, K, d, P[:N], p[:N], z_stage)
    (x_N, phi), (x_st, u, y_st, convals_st, zproj_st) = jax.lax.scan(
        step, init, xs, unroll=_unroll(N)
    )
    cost_N, convals_N, zproj_N = al.al_cost(problem, N, x_N, None, z_term, rho, terminal=True)
    phi = phi + cost_N
    y_N = mv(P[N], x_N - ref_x[N]) + p[N]
    x = jnp.concatenate([x_st, x_N[None]], axis=0)
    y = jnp.concatenate([y_st, y_N[None]], axis=0)
    convals = tuple(
        jnp.concatenate([cs, cN[None]], axis=0) for cs, cN in zip(convals_st, convals_N)
    )
    zproj = tuple(
        jnp.concatenate([zs, zN[None]], axis=0) for zs, zN in zip(zproj_st, zproj_N)
    )
    return MeritOutLight(phi, x, u, y, convals, zproj)


def merit_rollout_phi_x(problem: Problem, ref_x, ref_u, K, d, z, rho, alpha, x0):
    """Minimal trial rollout: AL merit value + state trajectory ONLY.

    The sequential scan of `merit_rollout_light` stripped to its
    irreducible carrier: everything else in the light payload (u, y,
    convals, zproj) is a per-knot pure function of the states — see
    `light_from_xstack`. Used by the grid line search so the trial grid
    materializes width x [N+1, n] states instead of width x full payload
    stacks. phi is bitwise-identical to `merit_rollout_light`'s.
    """
    N = problem.N
    dtype = x0.dtype
    alpha = jnp.asarray(alpha, dtype)
    ks = jnp.arange(N, dtype=jnp.int32)
    z_stage = tuple(zj[:N] for zj in z)
    z_term = tuple(zj[N] for zj in z)

    def step(carry, inp):
        x_k, phi = carry
        k, xr, ur, K_k, d_k, z_k = inp
        u_k = ur - mv(K_k, x_k - xr) + alpha * d_k
        x_next = problem.dyn_step(k, x_k, u_k)
        cost_k, _, _ = al.al_cost(problem, k, x_k, u_k, z_k, rho, terminal=False)
        return (x_next, phi + cost_k), x_k

    (x_N, phi), x_st = jax.lax.scan(
        step, (x0, jnp.asarray(0.0, dtype)),
        (ks, ref_x[:N], ref_u, K, d, z_stage), unroll=_unroll(N)
    )
    cost_N, _, _ = al.al_cost(problem, N, x_N, None, z_term, rho, terminal=True)
    return phi + cost_N, jnp.concatenate([x_st, x_N[None]], axis=0)


def light_from_xstack(
    problem: Problem, phi, x, ref_x, ref_u, K, d, P, p, z, rho, alpha
) -> MeritOutLight:
    """Rebuild the light merit payload from a rolled-out state trajectory.

    Knot-parallel (one vmap): u and y from the policy/dual-estimate
    affine maps, convals/zproj by re-evaluating the constraints at
    (x, u). Identical values to `merit_rollout_light` by construction
    (same per-knot expressions, same inputs).
    """
    N = problem.N
    alpha = jnp.asarray(alpha, x.dtype)
    dx = x - ref_x
    u = ref_u - jax.vmap(mv)(K, dx[:N]) + alpha * d
    y = jax.vmap(mv)(P, dx) + p
    ks = jnp.arange(N, dtype=jnp.int32)
    z_stage = tuple(zj[:N] for zj in z)
    z_term = tuple(zj[N] for zj in z)
    _, convals_st, zproj_st = jax.vmap(
        lambda k, xk, uk, zk: al.al_cost(problem, k, xk, uk, zk, rho, terminal=False)
    )(ks, x[:N], u, z_stage)
    _, convals_N, zproj_N = al.al_cost(problem, N, x[N], None, z_term, rho, terminal=True)
    convals = tuple(
        jnp.concatenate([cs, cN[None]], axis=0) for cs, cN in zip(convals_st, convals_N)
    )
    zproj = tuple(
        jnp.concatenate([zs, zN[None]], axis=0) for zs, zN in zip(zproj_st, zproj_N)
    )
    return MeritOutLight(phi, x, u, y, convals, zproj)


def al_gradients(problem: Problem, x, u, z, rho):
    """AL cost gradients (lx [N+1, n], lu [N, m]) along a trajectory,
    vmapped over the knot axis (the gradient half of
    `_cost_expansions_and_cost`)."""
    N = problem.N
    ks = jnp.arange(N, dtype=jnp.int32)
    z_stage = tuple(zj[:N] for zj in z)
    z_term = tuple(zj[N] for zj in z)
    lx_st, lu = jax.vmap(
        lambda k, xk, uk, zk: al.al_grad(problem, k, xk, uk, zk, rho, terminal=False)
    )(ks, x[:N], u, z_stage)
    lx_N, _ = al.al_grad(problem, N, x[N], None, z_term, rho, terminal=True)
    return jnp.concatenate([lx_st, lx_N[None]], axis=0), lu


def complete_merit_payload(
    problem: Problem, light: MeritOutLight, K, d, z, rho, with_dphi: bool = True
) -> Tuple[jnp.ndarray, MeritOut]:
    """Reconstruct the full `MeritOut` from a light rollout payload.

    Knot-parallel: dynamics expansions and AL gradients are one vmap over
    the knot axis; the directional derivative dphi/dalpha then follows
    from the same forward-sensitivity recurrence the in-rollout version
    uses (merit_function / solver.cpp:303-315), as a scan over cached
    linear data only. Returns (dphi, MeritOut).

    with_dphi=False (SolverOptions.ls_armijo_only) skips that sensitivity
    scan — the only sequential piece of the completion — and reports
    dphi = NaN; nothing on the solve path consumes it then (the next
    iteration's dphi(0) is the backward pass's expected-decrease
    identity).
    """
    A, B = dynamics_expansions(problem, light.x, light.u)
    lx, lu = al_gradients(problem, light.x, light.u, z, rho)
    if with_dphi:
        dphi = merit0_derivative(A, B, K, d, lx, lu)
    else:
        dphi = jnp.asarray(jnp.nan, light.phi.dtype)
    return dphi, MeritOut(
        phi=light.phi,
        dphi=dphi,
        x=light.x,
        u=light.u,
        y=light.y,
        A=A,
        B=B,
        lx=lx,
        lu=lu,
        convals=light.convals,
        zproj=light.zproj,
    )


# ---------------------------------------------------------------------------
# Expansions / optimality criteria
# ---------------------------------------------------------------------------


def _cost_expansions_and_cost(problem: Problem, x, u, z, rho, exact=False):
    """Per-knot AL cost expansion + total AL cost at a trajectory, vmapped
    over the knot axis (dynamics Jacobians handled separately — they only
    depend on (x, u) and are reused from the accepted merit evaluation).

    Parity: CalcExpansions / CalcCostGradient (solver.cpp:176-201) plus
    CalcCost (solver.cpp:163-174) in one pass.
    exact=True (SolverOptions.exact_al_hessian) swaps the Gauss-Newton
    AL Hessian for the full-Newton autodiff one (al.al_hess_exact) —
    no reference analog.
    Returns (lx, lu, lxx, luu, lux, al_cost_total).
    """
    N = problem.N
    ks = jnp.arange(N, dtype=jnp.int32)
    z_stage = tuple(zj[:N] for zj in z)
    z_term = tuple(zj[N] for zj in z)
    hess = al.al_hess_exact if exact else al.al_hess

    def stage(k, x_k, u_k, z_k):
        lx, lu = al.al_grad(problem, k, x_k, u_k, z_k, rho, terminal=False)
        lxx, luu, lux = hess(problem, k, x_k, u_k, z_k, rho, terminal=False)
        cost_k, _, _ = al.al_cost(problem, k, x_k, u_k, z_k, rho, terminal=False)
        return lx, lu, lxx, luu, lux, cost_k

    lx_st, lu, lxx_st, luu, lux, cost_st = jax.vmap(stage)(ks, x[:N], u, z_stage)
    lx_N, _ = al.al_grad(problem, N, x[N], None, z_term, rho, terminal=True)
    lxx_N = hess(problem, N, x[N], None, z_term, rho, terminal=True)[0]
    cost_N, _, _ = al.al_cost(problem, N, x[N], None, z_term, rho, terminal=True)
    lx = jnp.concatenate([lx_st, lx_N[None]], axis=0)
    lxx = jnp.concatenate([lxx_st, lxx_N[None]], axis=0)
    return lx, lu, lxx, luu, lux, jnp.sum(cost_st) + cost_N


def _cost_expansions_and_cost_diag(problem: Problem, x, u, z, rho):
    """Diagonal-storage variant of `_cost_expansions_and_cost` (the
    reference's is_diag fast path, tvlqr.cpp:85-89,125-128, extended to
    the AL Hessian). Valid only when `al.diag_expansion_eligible`; returns
    (lx, lu, lxx_diag [N+1, n], luu_diag [N, m], None, al_cost_total) —
    the dense [.., n, n] Hessian stacks are never materialized."""
    N = problem.N
    ks = jnp.arange(N, dtype=jnp.int32)
    z_stage = tuple(zj[:N] for zj in z)
    z_term = tuple(zj[N] for zj in z)

    def stage(k, x_k, u_k, z_k):
        lx, lu = al.al_grad(problem, k, x_k, u_k, z_k, rho, terminal=False)
        lxxd, luud = al.al_hess_diag(problem, k, x_k, u_k, z_k, rho, terminal=False)
        cost_k, _, _ = al.al_cost(problem, k, x_k, u_k, z_k, rho, terminal=False)
        return lx, lu, lxxd, luud, cost_k

    lx_st, lu, lxxd_st, luud, cost_st = jax.vmap(stage)(ks, x[:N], u, z_stage)
    lx_N, _ = al.al_grad(problem, N, x[N], None, z_term, rho, terminal=True)
    lxxd_N, _ = al.al_hess_diag(problem, N, x[N], None, z_term, rho, terminal=True)
    cost_N, _, _ = al.al_cost(problem, N, x[N], None, z_term, rho, terminal=True)
    lx = jnp.concatenate([lx_st, lx_N[None]], axis=0)
    lxxd = jnp.concatenate([lxxd_st, lxxd_N[None]], axis=0)
    return lx, lu, lxxd, luud, None, jnp.sum(cost_st) + cost_N


def dynamics_expansions(problem: Problem, x, u):
    """(A, B) stacks at a trajectory (CalcDynamicsExpansion, vmapped)."""
    ks = jnp.arange(problem.N, dtype=jnp.int32)
    return jax.vmap(lambda k, xk, uk: problem.dyn_expansion(k, xk, uk))(
        ks, x[: problem.N], u
    )


def _expansions_and_cost(problem: Problem, x, u, z, rho):
    lx, lu, lxx, luu, lux, alc = _cost_expansions_and_cost(problem, x, u, z, rho)
    A, B = dynamics_expansions(problem, x, u)
    return A, B, lx, lu, lxx, luu, lux, alc


def al_expansions(problem: Problem, x, u, z, rho):
    """Per-knot AL cost expansion + dynamics expansion at a trajectory.

    Returns (A, B, lx, lu, lxx, luu, lux).
    """
    return _expansions_and_cost(problem, x, u, z, rho)[:7]


def merit0_derivative(A, B, K, d, lx, lu):
    """dphi/dalpha at alpha = 0 from cached expansion data.

    At alpha = 0 the merit trajectory coincides with the reference
    trajectory (the reference was produced by the same closed-loop
    rollout), so the forward-sensitivity recurrence of
    MeritFunction (solver.cpp:303-315) only needs the cached A, B, lx,
    lu — a cheap linear scan with no dynamics/constraint evaluations.
    """
    N = A.shape[0]
    dx0 = jnp.zeros((A.shape[1],), A.dtype)

    def step(dx_da, inp):
        A_k, B_k, K_k, d_k, lx_k, lu_k = inp
        du_da = -mv(K_k, dx_da) + d_k
        contrib = jnp.dot(lx_k, dx_da) + jnp.dot(lu_k, du_da)
        return mv(A_k, dx_da) + mv(B_k, du_da), contrib

    dx_da_N, contribs = jax.lax.scan(
        step, dx0, (A, B, K, d, lx[:N], lu), unroll=_unroll(N)
    )
    return jnp.sum(contribs) + jnp.dot(lx[N], dx_da_N)


def stationarity(A, B, lx, lu, y):
    """max-norm KKT stationarity residual. Parity: solver.cpp:207-222."""
    N = A.shape[0]
    res_x = lx[:N] + mtv(A, y[1:]) - y[:N]
    res_u = lu + mtv(B, y[1:])
    res_term = lx[N] - y[N]
    return jnp.maximum(
        jnp.maximum(jnp.max(jnp.abs(res_x)), jnp.max(jnp.abs(res_u))),
        jnp.max(jnp.abs(res_term)),
    )


def feasibility(problem: Problem, convals):
    """max over knots/groups of ||P_K(c) - c||_inf. Parity: solver.cpp:224-231."""
    viol = jnp.asarray(0.0, problem.x0.dtype)
    for spec, c_j in zip(problem.constraints, convals):
        v = jax.vmap(lambda cc: cones.project(spec.cone, cc))(c_j) - c_j
        masked = jnp.where(spec.active[:, None], jnp.abs(v), 0.0)
        viol = jnp.maximum(viol, jnp.max(masked) if masked.size else 0.0)
    return viol


def complementarity(problem: Problem, convals, z):
    comp = jnp.asarray(0.0, problem.x0.dtype)
    for spec, c_j, z_j in zip(problem.constraints, convals, z):
        masked = jnp.where(spec.active[:, None], jnp.abs(c_j * z_j), 0.0)
        comp = jnp.maximum(comp, jnp.max(masked) if masked.size else 0.0)
    return comp


def total_cost(problem: Problem, x, u):
    """Original objective (no AL terms) along a trajectory."""
    ks = jnp.arange(problem.N, dtype=jnp.int32)
    stage = jax.vmap(lambda k, xk, uk: problem.cost.stage_value(k, xk, uk))(ks, x[: problem.N], u)
    return jnp.sum(stage) + problem.cost.term_value(x[problem.N])


def al_total_cost(problem: Problem, x, u, z, rho):
    """Objective + AL penalty terms (reference CalcCost, solver.cpp:163-174)."""
    ks = jnp.arange(problem.N, dtype=jnp.int32)
    z_stage = tuple(zj[: problem.N] for zj in z)
    z_term = tuple(zj[problem.N] for zj in z)
    stage = jax.vmap(
        lambda k, xk, uk, zk: al.al_cost(problem, k, xk, uk, zk, rho, terminal=False)[0]
    )(ks, x[: problem.N], u, z_stage)
    term = al.al_cost(problem, problem.N, x[problem.N], None, z_term, rho, terminal=True)[0]
    return jnp.sum(stage) + term


# ---------------------------------------------------------------------------
# Backward pass with adaptive regularization
# ---------------------------------------------------------------------------


def _retry_loop(opts: SolverOptions, attempt, reg0):
    """Adaptive-regularization retry: on Cholesky failure bump reg
    geometrically (up to reg_max_retries) and re-run `attempt`.

    The reference hardwires reg = 0 and aborts the solve on failure
    (solver.cpp:363, 373-377); here a failed factorization retries so a
    lane recovers instead of dying.
    """
    gains0 = attempt(reg0)

    def cond(c):
        g, reg, tries = c
        return jnp.logical_and(jnp.logical_not(g.ok), tries < opts.reg_max_retries)

    def body(c):
        g, reg, tries = c
        new_reg = jnp.where(reg <= 0, opts.reg_min, reg * opts.reg_scaling)
        return attempt(new_reg), new_reg, tries + 1

    gains, reg_used, _ = jax.lax.while_loop(
        cond, body, (gains0, reg0, jnp.asarray(0, jnp.int32))
    )
    return gains, reg_used


def backward_adaptive(opts: SolverOptions, A, B, lxx, luu, lux, lx, lu, reg0):
    """Riccati backward pass with the adaptive-regularization retry."""
    f_zero = jnp.zeros_like(lx[: A.shape[0]])

    if opts.parallel_riccati:
        def attempt(reg):
            return tvlqr_backward_associative(
                A, B, f_zero, lxx, luu, lux, lx, lu, reg,
                chunk=opts.parallel_riccati_chunk or None,
            )
    else:
        def attempt(reg):
            return tvlqr_backward(
                A, B, f_zero, lxx, luu, lux, lx, lu, reg,
                symmetrize=opts.symmetrize_ctg,
            )

    return _retry_loop(opts, attempt, reg0)


# ---------------------------------------------------------------------------
# Solve
# ---------------------------------------------------------------------------


class _Carry(NamedTuple):
    x: jnp.ndarray
    u: jnp.ndarray
    y: jnp.ndarray
    z: Tuple[jnp.ndarray, ...]
    rho: jnp.ndarray
    K: jnp.ndarray
    d: jnp.ndarray
    P: jnp.ndarray
    p: jnp.ndarray
    reg: jnp.ndarray
    convals: Tuple[jnp.ndarray, ...]
    A: jnp.ndarray  # dynamics expansion at (x, u) — reused across stages
    B: jnp.ndarray
    iter: jnp.ndarray
    status: jnp.ndarray
    stop: jnp.ndarray
    phi: jnp.ndarray
    dphi: jnp.ndarray
    alpha: jnp.ndarray
    stat: jnp.ndarray
    feas: jnp.ndarray
    ls_iters: jnp.ndarray
    ls_fails: jnp.ndarray  # int32 count of failed line searches (recovery cap)
    bp_fail_index: jnp.ndarray  # int32, last backward pass (N = ok)


def solve(problem: Problem, state: SolverState, opts: SolverOptions = SolverOptions()):
    """Run the fused AL-iLQR loop. Returns (SolverState, SolveStats).

    Parity with SolverImpl::Solve (solver.cpp:414-511):
      1. open-loop rollout from problem.x0 with the carried inputs
         (this is also the warm-start path for MPC resolves)
      2. iterate: expansions -> Riccati backward pass -> merit(0) ->
         line search -> accept candidate -> stationarity/feasibility ->
         adaptive dual & penalty updates when near-stationary
      3. per-lane status instead of exceptions.
    """
    N = problem.N
    dtype = problem.x0.dtype
    if opts.ls_armijo_only and not (opts.rti_mode or opts.ls_phase_split):
        raise ValueError(
            "ls_armijo_only requires ls_phase_split (or rti_mode): without "
            "the phase-split line search the directional derivative is "
            "computed inside the merit rollout and cannot be skipped"
        )
    ls_opts = LineSearchOptions(
        c1=opts.ls_c1,
        c2=opts.ls_c2,
        max_iters=opts.ls_max_iters,
        alpha_max=opts.ls_alpha_max,
        beta_increase=opts.ls_beta_increase,
        beta_decrease=opts.ls_beta_decrease,
        min_interval_size=opts.ls_min_interval_size,
        try_cubic_first=opts.ls_try_cubic_first,
        use_backtracking=opts.use_backtracking_linesearch,
        armijo_slack=opts.ls_armijo_slack,
        verbose=opts.verbose >= Verbosity.LINE_SEARCH,
    )

    # Diagonal expansion storage on the DEFAULT (scan) path: when the AL
    # Hessian is provably diagonal, store [N+1, n] diagonals and run the
    # diag Riccati step — the reference's is_diag fast path
    # (tvlqr.cpp:85-89,125-128). The parallel Riccati keeps dense
    # operands (its ABI is dense); the tiled path handles diag itself.
    diag_mode = (
        opts.diag_expansion
        and al.diag_expansion_eligible(problem)
        and not opts.parallel_riccati
        and not opts.exact_al_hessian  # exact Hessians are dense
    )

    # Prologue (solver.cpp:418-434): reset penalty, rollout, make reference
    rho0 = jnp.asarray(opts.penalty_initial, dtype)
    if opts.penalty_warm_start:
        # Carry the escalated penalty across warm-started resolves (see
        # SolverOptions.penalty_warm_start); the reference resets it.
        rho0 = jnp.clip(
            state.rho.astype(dtype) * jnp.asarray(opts.penalty_warm_start_decay, dtype),
            rho0,
            jnp.asarray(opts.penalty_max, dtype),
        )
    x_init = open_loop_rollout(problem, state.u)
    convals0 = _trajectory_convals(problem, x_init, state.u)
    A0, B0 = dynamics_expansions(problem, x_init, state.u)

    if opts.verbose > Verbosity.SILENT:  # solver.cpp:438-441
        jax.debug.print(
            "STARTING ALTRO iLQR SOLVE....\n  Initial Cost: {c}",
            c=al_total_cost(problem, x_init, state.u, state.z, rho0),
        )

    init = _Carry(
        x=x_init,
        u=state.u,
        y=state.y,
        z=state.z,
        rho=rho0,
        K=state.K,
        d=state.d,
        P=state.P,
        p=state.p,
        reg=jnp.asarray(opts.reg_initial, dtype),
        convals=convals0,
        A=A0,
        B=B0,
        iter=jnp.asarray(0, jnp.int32),
        status=jnp.asarray(int(SolveStatus.UNSOLVED), jnp.int32),
        stop=jnp.asarray(False),
        phi=jnp.asarray(0.0, dtype),
        dphi=jnp.asarray(0.0, dtype),
        alpha=jnp.asarray(0.0, dtype),
        stat=jnp.asarray(jnp.inf, dtype),
        feas=jnp.asarray(jnp.inf, dtype),
        ls_iters=jnp.asarray(0, jnp.int32),
        ls_fails=jnp.asarray(0, jnp.int32),
        bp_fail_index=jnp.asarray(N, jnp.int32),
    )

    def cond(c: _Carry):
        return jnp.logical_and(jnp.logical_not(c.stop), c.iter < opts.iterations_max)

    def body(c: _Carry):
        # 1. AL cost expansions (+ AL cost = phi(0)) at the reference
        #    trajectory; the dynamics Jacobians A, B depend only on
        #    (x, u) and are reused from the accepted merit evaluation
        # 2. Riccati backward pass with adaptive regularization
        A, B = c.A, c.B
        if diag_mode:
            expand = _cost_expansions_and_cost_diag
        elif opts.exact_al_hessian:
            expand = functools.partial(_cost_expansions_and_cost, exact=True)
        else:
            expand = _cost_expansions_and_cost
        lx, lu, lxx, luu, lux, phi0 = expand(problem, c.x, c.u, c.z, c.rho)
        gains, reg_used = backward_adaptive(
            opts, A, B, lxx, luu, lux, lx, lu, c.reg
        )
        bp_failed = jnp.logical_not(gains.ok)

        # 3. Merit derivative at alpha = 0: the classical iLQR
        #    expected-decrease identity dphi(0) = DeltaV_1 = sum_k d_k.Qu_k
        #    — already accumulated by the backward pass, so no scan at
        #    all. Equal to the forward-sensitivity recurrence
        #    (MeritFunction(0), solver.cpp:303-315; also
        #    merit0_derivative) to machine epsilon.
        dphi0 = gains.delta_V[0]

        def merit_full(alpha):
            out = merit_function(
                problem, c.x, c.u, gains.K, gains.d, gains.P, gains.p, c.z, c.rho,
                alpha, problem.x0, with_derivative=True,
            )
            return out.phi, out.dphi, out

        # 4. Line search (solver.cpp:237-271); the payload of its last
        #    evaluation is carried so the accepted step's trajectory data
        #    need not be recomputed. RTI mode skips the search and takes
        #    the full step.
        grad_small = jnp.abs(dphi0) < opts.tol_meritfun_gradient
        aux0 = _alpha0_merit_out(problem, c, A, B, lx, lu, gains, phi0, dphi0)
        if opts.rti_mode:
            one = jnp.asarray(1.0, dtype)
            if opts.ls_phase_split:
                if opts.ls_grid_x_only:
                    # the sequential scan emits only (phi, states); u, y,
                    # convals, zproj are rebuilt knot-parallel
                    phi_rti, xstack = merit_rollout_phi_x(
                        problem, c.x, c.u, gains.K, gains.d,
                        c.z, c.rho, one, problem.x0,
                    )
                    light = light_from_xstack(
                        problem, phi_rti, xstack, c.x, c.u, gains.K,
                        gains.d, gains.P, gains.p, c.z, c.rho, one,
                    )
                else:
                    light = merit_rollout_light(
                        problem, c.x, c.u, gains.K, gains.d, gains.P, gains.p,
                        c.z, c.rho, one, problem.x0,
                    )
                _, m_rti = complete_merit_payload(
                    problem, light, gains.K, gains.d, c.z, c.rho,
                    with_dphi=not opts.ls_armijo_only,
                )
            else:
                _, _, m_rti = merit_full(one)
            alpha = one
            ls_failed = jnp.asarray(False)
            ls_iters = jnp.asarray(1, jnp.int32)
            m = m_rti
        else:
            if opts.parallel_linesearch:
                if not opts.use_backtracking_linesearch:
                    raise ValueError(
                        "parallel_linesearch requires use_backtracking_linesearch"
                    )
                if opts.ls_phase_split:
                    if opts.ls_grid_x_only:

                        def merit_light(alpha):
                            return merit_rollout_phi_x(
                                problem, c.x, c.u, gains.K, gains.d,
                                c.z, c.rho, alpha, problem.x0,
                            )

                        def reconstruct(xstack, alpha, phi):
                            return light_from_xstack(
                                problem, phi, xstack, c.x, c.u, gains.K,
                                gains.d, gains.P, gains.p, c.z, c.rho, alpha,
                            )

                    else:

                        def merit_light(alpha):
                            out = merit_rollout_light(
                                problem, c.x, c.u, gains.K, gains.d, gains.P,
                                gains.p, c.z, c.rho, alpha, problem.x0,
                            )
                            return out.phi, out

                        reconstruct = None

                    ls = parallel_backtracking_search_split(
                        merit_light,
                        lambda light, with_dphi=True: complete_merit_payload(
                            problem, light, gains.K, gains.d, c.z, c.rho,
                            with_dphi=with_dphi,
                        ),
                        phi0, dphi0, 1.0, ls_opts,
                        width=opts.ls_parallel_width,
                        armijo_only=opts.ls_armijo_only,
                        reconstruct=reconstruct,
                        best_decrease_fallback=opts.ls_best_decrease_fallback,
                    )
                else:
                    ls = parallel_backtracking_search(
                        merit_full, phi0, dphi0, 1.0, ls_opts, aux0=aux0,
                        width=opts.ls_parallel_width,
                    )
            else:
                ls = wolfe_line_search(
                    merit_full, None, phi0, dphi0, 1.0, ls_opts, aux0=aux0
                )
            alpha = jnp.where(grad_small, 0.0, ls.alpha)
            ls_ok = jnp.logical_or(
                ls.code == int(LineSearchCode.MINIMUM_FOUND),
                ls.code == int(LineSearchCode.HIT_MAX_STEPSIZE),
            )
            ls_failed = jnp.logical_and(
                jnp.logical_not(grad_small),
                jnp.logical_or(jnp.isnan(alpha), jnp.logical_not(ls_ok)),
            )
            # widened final-step acceptance: BEST_DECREASE counts as a
            # failure for status/recovery but its payload is real
            # progress and IS the carried trajectory
            ls_accepted = jnp.logical_or(
                ls_ok, ls.code == int(LineSearchCode.BEST_DECREASE)
            )
            ls_iters = ls.n_iters

            # 5. Data at the accepted step. On every success path the line
            #    search's last evaluation IS at the returned alpha (verified
            #    by construction: MINIMUM_FOUND / WINDOW_TOO_SMALL /
            #    HIT_MAX_STEPSIZE all return the just-evaluated step), so its
            #    carried payload is exactly merit(alpha) — no recompute. The
            #    alpha = 0 payload (gradient-too-small short-circuit and all
            #    failure paths, which stop the solve) is assembled from the
            #    cached expansion data: the alpha = 0 trajectory IS the
            #    reference trajectory (cf. MeritFunction(0), solver.cpp:273).
            use_ls_payload = jnp.logical_and(
                jnp.logical_and(ls_accepted, jnp.logical_not(grad_small)),
                ls.aux_alpha == alpha,
            )
            m = jax.tree.map(
                lambda a, b: jnp.where(use_ls_payload, a, b), ls.aux, aux0
            )

        # 6. Optimality criteria at the candidate (solver.cpp:456-469)
        stat = stationarity(m.A, m.B, m.lx, m.lu, m.y)
        feas = feasibility(problem, m.convals)
        stat_tol = jnp.asarray(opts.tol_stationarity, dtype)
        if opts.tol_stationarity_rel > 0:
            # Relative-KKT form (SolverOptions.tol_stationarity_rel): the
            # residual cancels quantities of scale max(|lx|,|lu|,|y|), so
            # its f32 floor is proportional to that scale.
            scale = jnp.maximum(
                jnp.maximum(jnp.max(jnp.abs(m.lx)), jnp.max(jnp.abs(m.lu))),
                jnp.max(jnp.abs(m.y)),
            )
            stat_tol = jnp.maximum(stat_tol, opts.tol_stationarity_rel * scale)
        # Divergence guards (statically compiled out at the inf
        # defaults): the reference's declared-but-unread
        # max_state_value / max_input_value (solver_options.hpp:28-29)
        # and the dead MaxObjectiveExceeded status (typedefs.hpp:22)
        # made real.
        x_oob = jnp.asarray(False)
        u_oob = jnp.asarray(False)
        obj_exceeded = jnp.asarray(False)
        if math.isfinite(opts.max_state_value):
            x_oob = jnp.max(jnp.abs(m.x)) > opts.max_state_value
        if math.isfinite(opts.max_input_value):
            u_oob = jnp.max(jnp.abs(m.u)) > opts.max_input_value
        if math.isfinite(opts.max_objective_value):
            obj_exceeded = jnp.logical_or(
                jnp.logical_not(jnp.isfinite(m.phi)),
                m.phi > opts.max_objective_value,
            )
        diverged = jnp.logical_or(
            obj_exceeded, jnp.logical_or(x_oob, u_oob)
        )

        converged = jnp.logical_and(
            jnp.abs(stat) < stat_tol, feas < opts.tol_primal_feasibility
        )
        if opts.enable_cost_tolerance:
            # Intended-but-unwired reference criterion (tol_cost,
            # solver_options.hpp:20): accepted-step merit decrease below
            # tol_cost at a feasible point. c.phi is the previous
            # iteration's accepted merit (invalid at iter 0).
            cost_converged = jnp.logical_and(
                jnp.logical_and(
                    c.iter > 0, jnp.abs(c.phi - m.phi) < opts.tol_cost
                ),
                feas < opts.tol_primal_feasibility,
            )
            converged = jnp.logical_or(converged, cost_converged)

        # 7. Adaptive dual/penalty update (solver.cpp:471-489)
        do_dual = stat < jnp.sqrt(jnp.asarray(opts.tol_stationarity, dtype))
        z_new = tuple(
            jnp.where(
                jnp.logical_and(do_dual, spec.active[:, None]), zp, zj
            )
            for spec, zp, zj in zip(problem.constraints, m.zproj, c.z)
        )
        do_penalty = jnp.logical_and(do_dual, feas > opts.tol_primal_feasibility)
        rho_new = jnp.where(
            do_penalty,
            jnp.minimum(c.rho * opts.penalty_scaling, opts.penalty_max),
            c.rho,
        )

        # Status chain. MERIT_FUN_GRADIENT_TOO_SMALL mirrors the
        # reference's ForwardPass early-out (solver.cpp:242-245) AND its
        # loop semantics (solver.cpp:451 treats it as benign: the solve
        # keeps iterating so a dual/penalty update can reshape the merit
        # landscape) — sticky only while the gradient stays small, like
        # the recovery path's LINE_SEARCH_FAILED.
        grad_small_stat = (
            jnp.asarray(False) if opts.rti_mode else grad_small
        )
        prev_status = jnp.where(
            c.status == int(SolveStatus.MERIT_FUN_GRADIENT_TOO_SMALL),
            int(SolveStatus.UNSOLVED),
            c.status,
        )
        status = jnp.where(
            converged,
            int(SolveStatus.SUCCESS),
            jnp.where(
                ls_failed,
                int(SolveStatus.LINE_SEARCH_FAILED),
                jnp.where(
                    bp_failed,
                    int(SolveStatus.BACKWARD_PASS_FAILED),
                    jnp.where(
                        obj_exceeded,
                        int(SolveStatus.MAX_OBJECTIVE_EXCEEDED),
                        jnp.where(
                            x_oob,
                            int(SolveStatus.STATE_OUT_OF_BOUNDS),
                            jnp.where(
                                u_oob,
                                int(SolveStatus.INPUT_OUT_OF_BOUNDS),
                                jnp.where(
                                    grad_small_stat,
                                    int(SolveStatus.MERIT_FUN_GRADIENT_TOO_SMALL),
                                    prev_status,
                                ),
                            ),
                        ),
                    ),
                ),
            ),
        ).astype(jnp.int32)
        if opts.ls_failure_recovery:
            # Don't abort on a failed line search: carry the alpha = 0
            # payload (m already falls back to it), escalate reg for the
            # next backward, and let the dual/penalty machinery reshape
            # the merit landscape. Status semantics: LINE_SEARCH_FAILED
            # sticks only while failing; a later passing step clears it
            # back to UNSOLVED (so an unconverged-but-recovered lane ends
            # MAX_ITERATIONS, not LINE_SEARCH_FAILED).
            reg_cap = opts.reg_min * opts.reg_scaling ** opts.reg_max_retries
            reg_used = jnp.where(
                ls_failed,
                jnp.minimum(
                    jnp.where(reg_used <= 0, opts.reg_min,
                              reg_used * opts.reg_scaling),
                    reg_cap,
                ),
                reg_used,
            )
            status = jnp.where(
                jnp.logical_and(
                    jnp.logical_not(ls_failed),
                    jnp.logical_and(
                        jnp.logical_not(converged),
                        c.status == int(SolveStatus.LINE_SEARCH_FAILED),
                    ),
                ),
                int(SolveStatus.UNSOLVED),
                status,
            ).astype(jnp.int32)
            ls_fails_new = c.ls_fails + ls_failed.astype(jnp.int32)
            cap = opts.ls_recovery_max_fails
            recovery_exhausted = (
                jnp.logical_and(ls_failed, ls_fails_new > cap)
                if cap > 0 else jnp.zeros_like(ls_failed)
            )
            stop = jnp.logical_or(
                converged, jnp.logical_or(bp_failed, recovery_exhausted))
        else:
            ls_fails_new = c.ls_fails + ls_failed.astype(jnp.int32)
            stop = jnp.logical_or(
                converged, jnp.logical_or(ls_failed, bp_failed))
        stop = jnp.logical_or(stop, diverged)

        if opts.iteration_callback is not None:
            jax.debug.callback(
                opts.iteration_callback, c.iter, m.phi, stat, feas, alpha, c.rho
            )
        if opts.verbose >= Verbosity.INNER:
            jax.debug.print(
                "  iter = {i}, phi = {p0:.6} -> {p:.6}, dphi = {d0:.4} -> {d:.4}, "
                "alpha = {a:.4}, ls_iter = {li}, stat = {s:.4}, feas = {f:.4}, "
                "rho = {r:.3}, dual update? {du}",
                i=c.iter, p0=phi0, p=m.phi, d0=dphi0, d=m.dphi, a=alpha,
                li=ls_iters, s=stat, f=feas, r=c.rho, du=do_dual,
            )
        elif opts.verbose == Verbosity.OUTER:
            # one line per AL outer round (dual/penalty update), the
            # coarse tier the reference declares but never distinguishes
            # from INNER (solver_options.hpp:14; every non-silent level
            # prints the same line there, solver.cpp:492-499)
            jax.lax.cond(
                do_dual,
                lambda: jax.debug.print(
                    "  outer: iter = {i}, phi = {p:.6}, stat = {s:.4}, "
                    "feas = {f:.4}, rho = {r:.3} -> {rn:.3}",
                    i=c.iter, p=m.phi, s=stat, f=feas, r=c.rho, rn=rho_new,
                ),
                lambda: None,
            )

        return _Carry(
            x=m.x,
            u=m.u,
            y=m.y,
            z=z_new,
            rho=rho_new,
            K=gains.K,
            d=gains.d,
            P=gains.P,
            p=gains.p,
            reg=reg_used,
            convals=m.convals,
            A=m.A,
            B=m.B,
            iter=c.iter + 1,
            status=status,
            stop=stop,
            phi=m.phi,
            dphi=m.dphi,
            alpha=alpha,
            stat=stat,
            feas=feas,
            ls_iters=ls_iters,
            ls_fails=ls_fails_new,
            bp_fail_index=gains.fail_index.astype(jnp.int32),
        )

    final = jax.lax.while_loop(cond, body, init)

    if opts.verbose > Verbosity.SILENT:  # solver.cpp:507-509
        jax.debug.print(
            "ALTRO SOLVE FINISHED! iterations = {i}, status = {s}",
            i=final.iter, s=final.status,
        )

    status = jnp.where(
        jnp.logical_and(
            final.status == int(SolveStatus.UNSOLVED), final.iter >= opts.iterations_max
        ),
        int(SolveStatus.MAX_ITERATIONS),
        final.status,
    ).astype(jnp.int32)

    new_state = SolverState(
        x=final.x,
        u=final.u,
        y=final.y,
        z=final.z,
        rho=final.rho,
        K=final.K,
        d=final.d,
        P=final.P,
        p=final.p,
        reg=final.reg,
    )
    stats = SolveStats(
        status=status,
        iterations=final.iter,
        objective_value=total_cost(problem, final.x, final.u),
        merit_value=final.phi,
        stationarity=final.stat,
        primal_feasibility=final.feas,
        complementarity=complementarity(problem, final.convals, final.z),
        rho=final.rho,
        alpha=final.alpha,
        ls_iterations=final.ls_iters,
        dphi=final.dphi,
        bp_fail_index=final.bp_fail_index,
    )
    return new_state, stats


def _alpha0_merit_out(problem: Problem, c: "_Carry", A, B, lx, lu, gains, phi0, dphi0) -> MeritOut:
    """merit(0) assembled from cached data, no rollout.

    At alpha = 0 the closed-loop trajectory equals the reference
    trajectory (du = -K*0 + 0*d), so x/u/constraint values are the cached
    ones, the TVLQR dual estimate is y = P*0 + p = p, and the AL
    gradients/dynamics expansions are the loop-top expansions. Projected
    duals are one vmapped cone projection per group.
    """
    z_est = tuple(
        zj - c.rho * cj for zj, cj in zip(c.z, c.convals)
    )
    zproj = tuple(
        jax.vmap(lambda ze: cones.project(cones.dual_cone(spec.cone), ze))(ze)
        for spec, ze in zip(problem.constraints, z_est)
    )
    return MeritOut(
        phi=phi0,
        dphi=dphi0,
        x=c.x,
        u=c.u,
        y=gains.p,
        A=A,
        B=B,
        lx=lx,
        lu=lu,
        convals=c.convals,
        zproj=zproj,
    )


def _trajectory_convals(problem: Problem, x, u):
    """Constraint values along a trajectory, per group [N+1, p]."""
    N = problem.N
    ks = jnp.arange(N, dtype=jnp.int32)
    stage = jax.vmap(lambda k, xk, uk: al.constraint_values(problem, k, xk, uk))(ks, x[:N], u)
    um = jnp.zeros((problem.m,), x.dtype)
    term = al.constraint_values(problem, N, x[N], um)
    return tuple(jnp.concatenate([s, t[None]], axis=0) for s, t in zip(stage, term))
