"""Augmented-Lagrangian machinery: projected duals, AL cost / gradient /
Gauss-Newton Hessian, constraint violations.

Batched redesign of the per-knot AL computations in
/root/reference/src/altro/solver/knotpoint_data.cpp:473-613. Every
function here operates on a single knot point and vmaps over the knot
axis (and over batch lanes); inactive knots are masked with `jnp.where`
instead of the reference's per-knot constraint lists.

The AL formulation (projected-dual / conic):
    z_est  = z - rho * c(x, u)              (estimated dual)
    z_proj = P_{K*}(z_est)                  (projection into dual cone)
    AL cost    += ||z_proj||^2 / (2 rho)
    AL grad    -= J_c^T  dP^T z_proj
    AL hess    += rho (dP J_c)^T (dP J_c)
                + rho J_c^T (d2P . z_proj) J_c     (nonlinear cones only)
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from altro_tpu import cones
from altro_tpu.ops.smallmat import mm, mtm, mtv
from altro_tpu.problem import Problem

__all__ = [
    "constraint_values",
    "projected_duals",
    "al_cost",
    "al_grad",
    "al_hess",
    "knot_violation",
]


def _terminal_u(problem: Problem):
    return jnp.zeros((problem.m,), dtype=problem.x0.dtype)


def constraint_values(problem: Problem, k, x, u) -> Tuple[jnp.ndarray, ...]:
    """c_j(x, u) for each constraint group. Parity: knotpoint_data.cpp:473-479."""
    return tuple(spec.fn(x, u, k) for spec in problem.constraints)


def projected_duals(problem: Problem, convals, z, rho):
    """(z_est, z_proj) per group. Parity: knotpoint_data.cpp:523-535."""
    z_est, z_proj = [], []
    for spec, c_j, z_j in zip(problem.constraints, convals, z):
        dual = cones.dual_cone(spec.cone)
        ze = z_j - rho * c_j
        z_est.append(ze)
        z_proj.append(cones.project(dual, ze))
    return tuple(z_est), tuple(z_proj)


def al_cost(problem: Problem, k, x, u, z, rho, terminal: bool):
    """Original cost + sum_j ||z_proj_j||^2/(2 rho) at one knot.

    Returns (cost, convals, z_proj). Parity: knotpoint_data.cpp:421-428,
    572-581.
    """
    if terminal:
        cost = problem.cost.term_value(x)
        u = _terminal_u(problem)
    else:
        cost = problem.cost.stage_value(k, x, u)
    convals = constraint_values(problem, k, x, u)
    _, z_proj = projected_duals(problem, convals, z, rho)
    for spec, zp in zip(problem.constraints, z_proj):
        active = spec.active[k]
        cost = cost + jnp.where(active, jnp.sum(zp * zp) / (2.0 * rho), 0.0)
    return cost, convals, z_proj


def al_grad(problem: Problem, k, x, u, z, rho, terminal: bool):
    """AL cost gradient (lx, lu) at one knot.

    Parity: knotpoint_data.cpp:430-437, 537-547, 583-595. lu is zeros at
    the terminal knot.
    """
    n = problem.n
    if terminal:
        u = _terminal_u(problem)
        lx = problem.cost.term_grad(x)
        lu = jnp.zeros((problem.m,), dtype=x.dtype)
    else:
        lx, lu = problem.cost.stage_grad(k, x, u)
    convals = constraint_values(problem, k, x, u)
    z_est, z_proj = projected_duals(problem, convals, z, rho)
    for spec, ze, zp in zip(problem.constraints, z_est, z_proj):
        dual = cones.dual_cone(spec.cone)
        Jc = spec.jacobian(x, u, k)  # [p, n+m]
        Pj = cones.project_jacobian(dual, ze)  # [p, p]
        jvp = mtv(Pj, zp)
        active = spec.active[k]
        lx = lx - jnp.where(active, mtv(Jc[:, :n], jvp), 0.0)
        if not terminal:
            lu = lu - jnp.where(active, mtv(Jc[:, n:], jvp), 0.0)
    return lx, lu


def al_hess(problem: Problem, k, x, u, z, rho, terminal: bool):
    """Gauss-Newton AL Hessian (lxx, luu, lux) at one knot.

    Parity: knotpoint_data.cpp:439-448, 549-570, 597-613.
    """
    n, m = problem.n, problem.m
    dtype = x.dtype
    if terminal:
        u = _terminal_u(problem)
        lxx = problem.cost.term_hess(x)
        luu = jnp.zeros((m, m), dtype)
        lux = jnp.zeros((m, n), dtype)
    else:
        lxx, luu, lux = problem.cost.stage_hess(k, x, u)
    convals = constraint_values(problem, k, x, u)
    z_est, z_proj = projected_duals(problem, convals, z, rho)
    for spec, ze, zp in zip(problem.constraints, z_est, z_proj):
        dual = cones.dual_cone(spec.cone)
        Jc = spec.jacobian(x, u, k)
        Pj = cones.project_jacobian(dual, ze)
        Jt = mm(Pj, Jc)  # [p, n+m]
        Hc = rho * mtm(Jt, Jt)
        if not cones.cone_is_linear(dual):
            Hp = cones.project_hessian(dual, ze, zp)  # [p, p]
            Hc = Hc + rho * mtm(Jc, mm(Hp, Jc))
        active = spec.active[k]
        lxx = lxx + jnp.where(active, Hc[:n, :n], 0.0)
        if not terminal:
            luu = luu + jnp.where(active, Hc[n:, n:], 0.0)
            lux = lux + jnp.where(active, Hc[n:, :n], 0.0)
    return lxx, luu, lux


def al_hess_exact(problem: Problem, k, x, u, z, rho, terminal: bool):
    """EXACT (full-Newton) AL Hessian (lxx, luu, lux) at one knot via
    autodiff through `al_cost` — includes the constraint-curvature term
    sum_e lambda_e * nabla^2 c_e that the Gauss-Newton form (al_hess,
    == reference knotpoint_data.cpp:549-570) drops. Measured effect:
    lifts the nonconvex-obstacle MPC convergence plateau (docs/PERF.md
    round 5). The projected-dual AL value is piecewise-C^2; autodiff
    returns the almost-everywhere Hessian, exactly as GN uses the
    a.e. projection Jacobian. May be indefinite: pair with the adaptive
    Quu regularization retry. SolverOptions.exact_al_hessian selects it.
    """
    m = problem.m
    dtype = x.dtype
    if terminal:
        def val_x(xx):
            return al_cost(problem, k, xx, None, z, rho, terminal=True)[0]

        lxx = jax.hessian(val_x)(x)
        return lxx, jnp.zeros((m, m), dtype), jnp.zeros((m, problem.n), dtype)

    def val(xx, uu):
        return al_cost(problem, k, xx, uu, z, rho, terminal=False)[0]

    lxx = jax.hessian(val, argnums=0)(x, u)
    luu = jax.hessian(val, argnums=1)(x, u)
    lux = jax.jacfwd(jax.grad(val, argnums=1), argnums=0)(x, u)
    return lxx, luu, lux


def diag_expansion_eligible(problem: Problem) -> bool:
    """True when the AL cost Hessian is diagonal at every knot: diagonal
    cost (the reference's is_diag fast path, tvlqr.cpp:85-89,125-128)
    and every constraint group declared `diag_hessian` (its projected
    Gauss-Newton term J^T dP^T dP J is diagonal — e.g. bound
    constraints, whose Jacobian rows are +-e_i)."""
    from altro_tpu.problem import DiagonalCost

    return isinstance(problem.cost, DiagonalCost) and all(
        spec.diag_hessian for spec in problem.constraints
    )


def al_hess_diag(problem: Problem, k, x, u, z, rho, terminal: bool):
    """Diagonal Gauss-Newton AL Hessian (lxx_diag [n], luu_diag [m]).

    Valid only when `diag_expansion_eligible(problem)`: the cost Hessian
    is diag(Q), diag(R) and each constraint's Gauss-Newton term
    rho * (dP J)^T (dP J) is diagonal (declared via
    ConstraintSpec.diag_hessian), so its diagonal sum_r (dP J)[r, c]^2
    IS the full matrix. Linear cones only (the SOC curvature term is
    never diagonal) — enforced by the diag_hessian declaration contract.
    """
    n, m = problem.n, problem.m
    dtype = x.dtype
    if terminal:
        u = _terminal_u(problem)
        lxxd = problem.cost.Q[-1]
        luud = jnp.zeros((m,), dtype)
    else:
        lxxd = problem.cost.Q[k]
        luud = problem.cost.R[k]
    convals = constraint_values(problem, k, x, u)
    z_est, _ = projected_duals(problem, convals, z, rho)
    for spec, ze in zip(problem.constraints, z_est):
        dual = cones.dual_cone(spec.cone)
        Jc = spec.jacobian(x, u, k)  # [p, n+m]
        Pj = cones.project_jacobian(dual, ze)  # [p, p]
        Jt = mm(Pj, Jc)
        hd = rho * jnp.sum(Jt * Jt, axis=0)  # diag of Jt^T Jt
        active = spec.active[k]
        lxxd = lxxd + jnp.where(active, hd[:n], 0.0)
        if not terminal:
            luud = luud + jnp.where(active, hd[n:], 0.0)
    return lxxd, luud


def knot_violation(problem: Problem, k, convals):
    """max_j ||P_K(c_j) - c_j||_inf at one knot (0 if nothing active).

    Parity: knotpoint_data.cpp:489-501.
    """
    viol = jnp.asarray(0.0, dtype=problem.x0.dtype)
    for spec, c_j in zip(problem.constraints, convals):
        v = cones.project(spec.cone, c_j) - c_j
        viol = jnp.maximum(viol, jnp.where(spec.active[k], jnp.max(jnp.abs(v)), 0.0))
    return viol
