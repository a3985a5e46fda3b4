"""Problem definition: costs, constraints, dynamics.

Batched redesign of the reference's per-knot `KnotPointData` problem
storage (/root/reference/src/altro/solver/knotpoint_data.hpp:160-233):
instead of an array-of-structs with per-knot Eigen workspaces, the problem
is a struct-of-arrays pytree — cost terms stacked `[N+1, ...]` along the
knot axis — plus JAX-traceable user callables for dynamics / generic costs
/ constraints. The reference's raw-pointer callback boundary
(/root/reference/src/altro/solver/typedefs.hpp:31-53) becomes "user
supplies JAX-traceable functions"; hand-coded Jacobians are optional
because `jax.jacfwd` provides them.

Heterogeneous constraint sets (the reference allows arbitrary per-knot
constraint lists, knotpoint_data.cpp:155-178) are expressed with static
shapes: each `ConstraintSpec` has a fixed cone/dim and a boolean `active`
mask over knot points, so everything vmaps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from altro_tpu.cones import Cone

__all__ = [
    "Cost",
    "DiagonalCost",
    "QuadraticCost",
    "GenericCost",
    "ConstraintSpec",
    "Problem",
    "lqr_cost_from_reference",
]


def _register(cls, data_fields, meta_fields):
    jax.tree_util.register_dataclass(cls, data_fields=data_fields, meta_fields=meta_fields)
    return cls


# ---------------------------------------------------------------------------
# Costs
# ---------------------------------------------------------------------------


class Cost:
    """Cost interface over knot index k (traced int32).

    Stage knots (k < N) have state+input terms; the terminal knot is
    state-only — mirrored from the reference cost types
    (knotpoint_data.cpp:616-708).
    """

    def stage_value(self, k, x, u):
        raise NotImplementedError

    def term_value(self, x):
        raise NotImplementedError

    def stage_grad(self, k, x, u):
        raise NotImplementedError

    def term_grad(self, x):
        raise NotImplementedError

    def stage_hess(self, k, x, u):
        raise NotImplementedError

    def term_hess(self, x):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class DiagonalCost(Cost):
    """0.5 x'diag(Q)x + q'x + 0.5 u'diag(R)u + r'u + c, stacked over knots.

    Q, q: [N+1, n];  R, r: [N+1, m] (row N unused);  c: [N+1].
    """

    Q: jnp.ndarray
    R: jnp.ndarray
    q: jnp.ndarray
    r: jnp.ndarray
    c: jnp.ndarray

    def stage_value(self, k, x, u):
        Qk, qk, Rk, rk, ck = self.Q[k], self.q[k], self.R[k], self.r[k], self.c[k]
        return (
            0.5 * jnp.dot(x, Qk * x)
            + jnp.dot(qk, x)
            + 0.5 * jnp.dot(u, Rk * u)
            + jnp.dot(rk, u)
            + ck
        )

    def term_value(self, x):
        return 0.5 * jnp.dot(x, self.Q[-1] * x) + jnp.dot(self.q[-1], x) + self.c[-1]

    def stage_grad(self, k, x, u):
        return self.Q[k] * x + self.q[k], self.R[k] * u + self.r[k]

    def term_grad(self, x):
        return self.Q[-1] * x + self.q[-1]

    def stage_hess(self, k, x, u):
        n = self.Q.shape[1]
        m = self.R.shape[1]
        return jnp.diag(self.Q[k]), jnp.diag(self.R[k]), jnp.zeros((m, n), self.Q.dtype)

    def term_hess(self, x):
        return jnp.diag(self.Q[-1])


_register(DiagonalCost, ["Q", "R", "q", "r", "c"], [])


@dataclasses.dataclass(frozen=True)
class QuadraticCost(Cost):
    """0.5 x'Qx + q'x + 0.5 u'Ru + r'u + u'Hx + c, stacked over knots.

    Q: [N+1, n, n];  R: [N+1, m, m];  H: [N+1, m, n];  q, r, c as diagonal.
    """

    Q: jnp.ndarray
    R: jnp.ndarray
    H: jnp.ndarray
    q: jnp.ndarray
    r: jnp.ndarray
    c: jnp.ndarray

    def stage_value(self, k, x, u):
        return (
            0.5 * jnp.dot(x, self.Q[k] @ x)
            + jnp.dot(self.q[k], x)
            + 0.5 * jnp.dot(u, self.R[k] @ u)
            + jnp.dot(self.r[k], u)
            + jnp.dot(u, self.H[k] @ x)
            + self.c[k]
        )

    def term_value(self, x):
        return 0.5 * jnp.dot(x, self.Q[-1] @ x) + jnp.dot(self.q[-1], x) + self.c[-1]

    def stage_grad(self, k, x, u):
        lx = self.Q[k] @ x + self.q[k] + self.H[k].T @ u
        lu = self.R[k] @ u + self.r[k] + self.H[k] @ x
        return lx, lu

    def term_grad(self, x):
        return self.Q[-1] @ x + self.q[-1]

    def stage_hess(self, k, x, u):
        return self.Q[k], self.R[k], self.H[k]

    def term_hess(self, x):
        return self.Q[-1]


_register(QuadraticCost, ["Q", "R", "H", "q", "r", "c"], [])


@dataclasses.dataclass(frozen=True)
class GenericCost(Cost):
    """User-supplied JAX-traceable cost callables.

    `stage(x, u, k) -> scalar`, `term(x) -> scalar`. Gradients/Hessians
    come from autodiff — this ships the reference's *intended* generic-cost
    support (its SetCostFunction drops the gradient/Hessian callbacks on
    the floor, knotpoint_data.cpp:112-121).
    """

    stage: Callable[..., jnp.ndarray]
    term: Callable[..., jnp.ndarray]

    def stage_value(self, k, x, u):
        return self.stage(x, u, k)

    def term_value(self, x):
        return self.term(x)

    def stage_grad(self, k, x, u):
        lx = jax.grad(self.stage, argnums=0)(x, u, k)
        lu = jax.grad(self.stage, argnums=1)(x, u, k)
        return lx, lu

    def term_grad(self, x):
        return jax.grad(self.term)(x)

    def stage_hess(self, k, x, u):
        lxx = jax.hessian(self.stage, argnums=0)(x, u, k)
        luu = jax.hessian(self.stage, argnums=1)(x, u, k)
        lux = jax.jacfwd(jax.grad(self.stage, argnums=1), argnums=0)(x, u, k)
        return lxx, luu, lux

    def term_hess(self, x):
        return jax.hessian(self.term)(x)


_register(GenericCost, [], ["stage", "term"])


def lqr_cost_from_reference(Q_diag, R_diag, x_ref, u_ref, terminal_index=None) -> DiagonalCost:
    """Build the diagonal tracking cost 0.5|x-xref|²_Q + 0.5|u-uref|²_R.

    Expands the references into (q, r, c) exactly as the reference's
    SetLQRCost (/root/reference/src/altro/altro_solver.cpp:138-172): the
    terminal knot's constant term has no input contribution.

    Args (stacked over knots):
      Q_diag: [N+1, n], R_diag: [N+1, m], x_ref: [N+1, n], u_ref: [N+1, m].
    """
    Q_diag, R_diag = jnp.asarray(Q_diag), jnp.asarray(R_diag)
    x_ref, u_ref = jnp.asarray(x_ref), jnp.asarray(u_ref)
    q = -Q_diag * x_ref
    r = -R_diag * u_ref
    c = 0.5 * jnp.sum(Q_diag * x_ref * x_ref, axis=1)
    cu = 0.5 * jnp.sum(R_diag * u_ref * u_ref, axis=1)
    Nt = Q_diag.shape[0] - 1 if terminal_index is None else terminal_index
    c = c + cu * (jnp.arange(Q_diag.shape[0]) != Nt)
    return DiagonalCost(Q=Q_diag, R=R_diag, q=q, r=r, c=c)


# ---------------------------------------------------------------------------
# Constraints
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConstraintSpec:
    """One constraint group: fixed cone/dim, active over a knot mask.

    fn(x, u, k) -> [dim]; membership is `project(cone, c) == c`
    (EQUALITY: c == 0; INEQUALITY: c <= 0; SOC: ||c[:-1]|| <= c[-1]).
    At the terminal knot fn receives u = zeros(m) (the reference keeps a
    zero input vector at the terminal knot, knotpoint_data.cpp:278-284).
    `jac(x, u, k) -> [dim, n + m]` is optional; defaults to jacfwd.
    """

    fn: Callable[..., jnp.ndarray]
    cone: Cone
    dim: int
    active: jnp.ndarray  # [N+1] bool
    jac: Optional[Callable[..., jnp.ndarray]] = None
    label: str = ""
    # Declares that this constraint's Gauss-Newton AL Hessian term
    # J^T dP^T dP J is DIAGONAL (e.g. bound constraints: Jacobian rows
    # are +-e_i, and the cone is linear so there is no curvature term).
    # Enables the diagonal expansion fast path (al.al_hess_diag /
    # SolverOptions.diag_expansion) — the reference's is_diag idea
    # (tvlqr.cpp:85-89,125-128) extended to the AL Hessian.
    diag_hessian: bool = False
    # Declares c(x, u, k) AFFINE in (x, u) at every knot (bound / box /
    # linear-halfspace constraints). Lets the tiled trial-rollout GPU
    # kernel (ops/pallas_rollout_tiled.py) evaluate the AL merit term
    # in-kernel from per-knot coefficient rows extracted once at trace
    # time (the reference pays zero structural cost for constraints in
    # its solve loop, solver.cpp:285-316).
    affine: bool = False

    def jacobian(self, x, u, k):
        if self.jac is not None:
            return self.jac(x, u, k)
        Jx = jax.jacfwd(self.fn, argnums=0)(x, u, k)
        Ju = jax.jacfwd(self.fn, argnums=1)(x, u, k)
        return jnp.concatenate([Jx, Ju], axis=1)


_register(ConstraintSpec, ["active"],
          ["fn", "cone", "dim", "jac", "label", "diag_hessian", "affine"])


# ---------------------------------------------------------------------------
# Problem
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Problem:
    """A discrete-time trajectory optimization problem.

    min  sum_k l_k(x_k, u_k) + l_N(x_N)
    s.t. x_{k+1} = f(x_k, u_k, h_k),  x_0 = x0,
         c_j(x_k, u_k) in K_j  for each constraint group j, active knots.

    Either `dynamics(x, u, h, k) -> x_next` (nonlinear, Jacobian by
    `dynamics_jac(x, u, h, k) -> [n, n+m]` or autodiff), or linear
    dynamics arrays A: [N, n, n], B: [N, n, m], f_aff: [N, n]
    (x' = Ax + Bu + f, the reference's SetLinearDynamics,
    knotpoint_data.cpp:123-142).
    """

    # static
    N: int
    n: int
    m: int
    dynamics: Optional[Callable[..., jnp.ndarray]]
    dynamics_jac: Optional[Callable[..., jnp.ndarray]]
    constraints: Tuple[ConstraintSpec, ...]
    # data
    cost: Cost
    h: jnp.ndarray  # [N]
    x0: jnp.ndarray  # [n]
    A: Optional[jnp.ndarray] = None
    B: Optional[jnp.ndarray] = None
    f_aff: Optional[jnp.ndarray] = None
    # Opt-in column-form dynamics step (models/tile_steps.py):
    # step(x_cols, u_cols, h) -> x_next_cols on tuples of per-component
    # arrays (each broadcast-compatible — lane vectors in the batched
    # rollout kernel), component-wise equal to `dynamics(x, u, h, k)`.
    # When set, tile-resident batched solves (tile_solver.solve_tiled)
    # on a GPU run the line-search trial grid inside one kernel
    # (ops/pallas_rollout_tiled.py) instead of a knot-sequential scan.
    dynamics_cols: Optional[Callable[..., tuple]] = None

    @property
    def linear_dynamics(self) -> bool:
        return self.dynamics is None

    def dyn_step(self, k, x, u):
        """x_{k+1} = f(x_k, u_k). Parity: knotpoint_data.cpp:710-719."""
        if self.linear_dynamics:
            return self.A[k] @ x + self.B[k] @ u + self.f_aff[k]
        return self.dynamics(x, u, self.h[k], k)

    def dyn_expansion(self, k, x, u):
        """(A_k, B_k) of the dynamics expansion at (x, u).

        Parity: knotpoint_data.cpp:406-419 (the expansion's affine term is
        zero — defect-free rollouts; CalcDynamicsExpansion zeroes f_).
        """
        if self.linear_dynamics:
            return self.A[k], self.B[k]
        if self.dynamics_jac is not None:
            J = self.dynamics_jac(x, u, self.h[k], k)
            return J[:, : self.n], J[:, self.n :]
        A = jax.jacfwd(self.dynamics, argnums=0)(x, u, self.h[k], k)
        B = jax.jacfwd(self.dynamics, argnums=1)(x, u, self.h[k], k)
        return A, B

    def dtype(self):
        return self.x0.dtype

    def num_constraint_groups(self) -> int:
        return len(self.constraints)

    def init_duals(self) -> Tuple[jnp.ndarray, ...]:
        """Zero dual variables, one [N+1, dim] array per constraint group."""
        return tuple(
            jnp.zeros((self.N + 1, spec.dim), dtype=self.x0.dtype) for spec in self.constraints
        )


_register(
    Problem,
    ["cost", "h", "x0", "A", "B", "f_aff", "constraints"],
    ["N", "n", "m", "dynamics", "dynamics_jac", "dynamics_cols"],
)
