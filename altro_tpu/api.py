"""Stateful convenience facade: `ALTROSolver`.

Mirrors the reference's public pimpl API
(/root/reference/src/altro/altro_solver.hpp:21-442) for users migrating
from the C++ solver: per-knot problem definition with [k_start, k_stop)
ranges and LAST_INDEX / ALL_INDICES sentinels, Initialize/Solve, MPC
updates, and getters. Internally everything compiles down to the pure
(Problem, SolverState) pytrees of `altro_tpu.solver`, so `solver.solve()`
is one jitted call and the same problem can be handed to the batched /
sharded runners in `altro_tpu.parallel`.

Also ships the reference's declared-but-unimplemented surface (SURVEY
§7.4): working state/input bound setters (as masked inequality cones),
feedback/feedforward-gain getters, fully-populated stats.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from altro_tpu.cones import Cone
from altro_tpu.options import SolverOptions
from altro_tpu.problem import (
    ConstraintSpec,
    DiagonalCost,
    GenericCost,
    Problem,
    QuadraticCost,
)
from altro_tpu.solver import (
    SolverState,
    al_total_cost,
    init_state,
    open_loop_rollout,
    solve as _solve,
    total_cost,
)
from altro_tpu.options import Verbosity
from altro_tpu.status import AltroError, ErrorCode, SolveStatus

__all__ = ["ALTROSolver", "LAST_INDEX", "ALL_INDICES"]

LAST_INDEX = -1
ALL_INDICES = -2

# Statuses throw_errors does NOT raise on. MERIT_FUN_GRADIENT_TOO_SMALL
# is benign per the reference loop (solver.cpp:451: the solve keeps
# iterating through it and returns NoError); MAX_SOLVE_TIME is the
# budget facility working as intended.
_BENIGN_STATUSES = frozenset(
    {
        SolveStatus.SUCCESS,
        SolveStatus.MAX_ITERATIONS,
        SolveStatus.MAX_SOLVE_TIME,
        SolveStatus.MERIT_FUN_GRADIENT_TOO_SMALL,
    }
)

_STATUS_ERROR_CODES = {
    SolveStatus.BACKWARD_PASS_FAILED: ErrorCode.BACKWARD_PASS_FAILED,
    SolveStatus.LINE_SEARCH_FAILED: ErrorCode.LINE_SEARCH_FAILED,
}


class ALTROSolver:
    """Define-then-solve API over the functional core.

    Typical use (mirrors the reference tests):

        solver = ALTROSolver(N)
        solver.set_dimension(n, m)
        solver.set_time_step(h)
        solver.set_explicit_dynamics(dyn)          # JAX-traceable f(x,u,h,k)
        solver.set_lqr_cost(Qd, Rd, xf, uf, 0, LAST_INDEX)
        solver.set_constraint(goal, n_goal, Cone.ZERO, "goal", N)
        solver.set_initial_state(x0)
        solver.initialize()
        status = solver.solve()
    """

    def __init__(self, horizon_length: int, dtype=None):
        if horizon_length <= 0:
            raise AltroError(ErrorCode.BAD_INDEX, "horizon must be positive")
        self.N = horizon_length
        self.dtype = dtype or jnp.result_type(float)
        self.n: Optional[int] = None
        self.m: Optional[int] = None
        # Per-knot dims (heterogeneous problems, tvlqr.h:15-33 /
        # altro_solver.cpp:26-60): the framework pads to (max n, max m)
        # internally — masked dynamics/cost/constraints on padded
        # coordinates — so the solver core keeps static shapes.
        self._nk: Optional[np.ndarray] = None
        self._mk: Optional[np.ndarray] = None
        self._h = np.zeros(self.N)
        self._dynamics: list = [None] * self.N  # per-knot callables
        self._dynamics_jac: list = [None] * self.N
        self._cost_kind = None  # "diagonal" | "quadratic" | "generic"
        self._cost_rows = None  # dict of stacked arrays
        self._generic_cost = None
        self._constraints: list[ConstraintSpec] = []
        self._x0 = None
        self._problem: Optional[Problem] = None
        self._state: Optional[SolverState] = None
        self._opts = SolverOptions()
        self._stats = None
        self._solve_time_ms = float("nan")
        self._solve_fn = None

    # ------------------------------------------------------------ ranges

    def _range(self, k_start: int, k_stop: int, inclusive: bool) -> range:
        """Reference index semantics (altro_solver.cpp:385-433):
        [k_start, k_stop); (0, LAST_INDEX) or (ALL_INDICES, 0) = full
        range; k_stop <= 0 selects the single index k_start."""
        terminal = self.N if inclusive else self.N - 1
        if k_start == ALL_INDICES and k_stop == 0:
            k_start, k_stop = 0, LAST_INDEX
        if k_start == 0 and k_stop == LAST_INDEX:
            return range(0, terminal + 1)
        if k_stop <= 0:
            k_stop = k_start + 1
        if not (0 <= k_start <= terminal) or k_stop > terminal + 1:
            raise AltroError(
                ErrorCode.BAD_INDEX, f"index range [{k_start},{k_stop}) out of [0,{terminal + 1})"
            )
        return range(k_start, k_stop)

    def _require_dims(self):
        if self.n is None or self.m is None:
            raise AltroError(ErrorCode.DIMENSION_UNKNOWN, "call set_dimension first")

    # ----------------------------------------------------------- setters

    def set_dimension(self, num_states: int, num_inputs: int,
                      k_start: int = 0, k_stop: int = LAST_INDEX):
        """Set (n_k, m_k) over a knot range. Heterogeneous per-knot
        dimensions (the reference TVLQR kernel's `const int *nx, *nu`,
        tvlqr.h:15-33, settable over ranges via SetDimension,
        altro_solver.cpp:26-60) are supported: the framework pads
        internally to (max n, max m) with zero dynamics rows, unit
        input-cost diagonal, and sliced user callables on the padded
        coordinates — call set_dimension BEFORE dynamics/cost/constraint
        setters for the knots involved."""
        if num_states <= 0:
            raise AltroError(ErrorCode.STATE_DIM_UNKNOWN)
        if num_inputs <= 0:
            raise AltroError(ErrorCode.INPUT_DIM_UNKNOWN)
        if self._nk is None:
            self._nk = np.full(self.N + 1, -1, dtype=int)
            self._mk = np.full(self.N + 1, -1, dtype=int)
        for k in self._range(k_start, k_stop, inclusive=True):
            self._nk[k] = num_states
            self._mk[k] = num_inputs
        new_n = int(self._nk.max())
        new_m = int(self._mk.max())
        grew = self.n is not None and (new_n > self.n or new_m > self.m)
        self.n, self.m = new_n, new_m
        if self._cost_rows is None:
            self._init_cost_rows()
        elif grew:
            self._grow_cost_rows()
        return self

    @property
    def _hetero(self) -> bool:
        if self._nk is None:
            return False
        known = self._nk >= 0
        return bool(
            np.any(self._nk[known] != self.n) or np.any(self._mk[known] != self.m)
        )

    def _knot_dims(self, k: int):
        """(n_k, m_k) — the knot's own dims (max dims if unset)."""
        if self._nk is None or self._nk[k] < 0:
            return self.n, self.m
        return int(self._nk[k]), int(self._mk[k])

    def _dims_groups(self, ks):
        """Partition knot indices by their (n_k, m_k)."""
        groups: dict = {}
        for k in ks:
            groups.setdefault(self._knot_dims(k), []).append(k)
        return groups

    def _grow_cost_rows(self):
        old = self._cost_rows
        self._init_cost_rows()
        for name, arr in old.items():
            sl = tuple(slice(0, s) for s in arr.shape)
            self._cost_rows[name][sl] = arr

    def _init_cost_rows(self):
        n, m, N = self.n, self.m, self.N
        self._cost_rows = dict(
            Q=np.zeros((N + 1, n)), R=np.zeros((N + 1, m)),
            q=np.zeros((N + 1, n)), r=np.zeros((N + 1, m)), c=np.zeros(N + 1),
            Qfull=np.zeros((N + 1, n, n)), Rfull=np.zeros((N + 1, m, m)),
            H=np.zeros((N + 1, m, n)),
        )

    def set_time_step(self, h: float, k_start: int = 0, k_stop: int = LAST_INDEX):
        if h <= 0:
            raise AltroError(ErrorCode.TIMESTEP_NOT_POSITIVE)
        # The reference stores timesteps as float32 (SetTimeStep(float h))
        h = float(np.float32(h))
        for k in self._range(k_start, k_stop, inclusive=False):
            self._h[k] = h
        return self

    def set_explicit_dynamics(self, dynamics: Callable, jacobian: Optional[Callable] = None,
                              k_start: int = 0, k_stop: int = LAST_INDEX):
        """dynamics(x, u, h, k) -> x_next (JAX-traceable).
        jacobian(x, u, h, k) -> [n, n+m] optional (default: jax.jacfwd)."""
        for k in self._range(k_start, k_stop, inclusive=False):
            self._dynamics[k] = dynamics
            self._dynamics_jac[k] = jacobian
        return self

    def set_tile_dynamics(self, step_cols: Callable):
        """Column-form dynamics step for the tiled trial-rollout GPU
        kernel (models/tile_steps.py protocol, Problem.dynamics_cols):
        step(x_cols, u_cols, h) on tuples of per-component arrays,
        component-wise equal to the explicit dynamics. Build it from
        column-form physics, e.g. step_cols = midpoint_cols(f_cols).

        With a diagonal cost and (if any) affine NEGATIVE_ORTHANT
        constraint groups — which the bound setters declare
        automatically — a tile-resident batched solve of this problem on
        a GPU runs the whole line-search trial grid in one kernel
        (ops/pallas_rollout_tiled.py). No reference analog."""
        self._dynamics_cols = step_cols
        if self._problem is not None:
            # already initialized: swap in place, keep the carried state
            self._problem = dataclasses.replace(
                self._problem, dynamics_cols=step_cols)
            self._solve_fn = None
        return self

    def set_linear_dynamics(self, A, B, f=None, k_start: int = 0, k_stop: int = LAST_INDEX):
        A = np.asarray(A)
        B = np.asarray(B)
        f = np.zeros(A.shape[0]) if f is None else np.asarray(f)
        Aj, Bj, fj = jnp.asarray(A, self.dtype), jnp.asarray(B, self.dtype), jnp.asarray(f, self.dtype)

        def dyn(x, u, h, k):
            return Aj @ x + Bj @ u + fj

        def jac(x, u, h, k):
            return jnp.concatenate([Aj, Bj], axis=1)

        return self.set_explicit_dynamics(dyn, jac, k_start, k_stop)

    def set_lqr_cost(self, Q_diag, R_diag, x_ref, u_ref,
                     k_start: int = 0, k_stop: int = LAST_INDEX):
        """Tracking cost 0.5|x-xref|^2_Q + 0.5|u-uref|^2_R, expanded into
        (q, r, c) exactly as the reference (altro_solver.cpp:138-172)."""
        self._require_dims()
        Qd, Rd = np.asarray(Q_diag, float), np.asarray(R_diag, float)
        xr, ur = np.asarray(x_ref, float), np.asarray(u_ref, float)
        rows = self._cost_rows
        for k in self._range(k_start, k_stop, inclusive=True):
            rows["Q"][k] = self._pad_row(Qd, self.n)
            rows["R"][k] = self._pad_row(Rd, self.m)
            rows["q"][k] = self._pad_row(-Qd * xr, self.n)
            rows["r"][k] = self._pad_row(-Rd * ur, self.m)
            c = 0.5 * float(xr @ (Qd * xr))
            if k != self.N:
                c += 0.5 * float(ur @ (Rd * ur))
            rows["c"][k] = c
        self._cost_kind = self._cost_kind or "diagonal"
        return self

    def set_diagonal_cost(self, Q_diag, R_diag, q, r, c: float = 0.0,
                          k_start: int = 0, k_stop: int = LAST_INDEX):
        self._require_dims()
        rows = self._cost_rows
        for k in self._range(k_start, k_stop, inclusive=True):
            rows["Q"][k] = self._pad_row(np.asarray(Q_diag, float), self.n)
            rows["R"][k] = self._pad_row(np.asarray(R_diag, float), self.m)
            rows["q"][k] = self._pad_row(np.asarray(q, float), self.n)
            rows["r"][k] = self._pad_row(np.asarray(r, float), self.m)
            rows["c"][k] = c
        self._cost_kind = self._cost_kind or "diagonal"
        return self

    @staticmethod
    def _pad_row(vec, size):
        """Zero-pad a knot-sized cost vector to the max dimension
        (heterogeneous problems; padded coordinates carry zero cost)."""
        vec = np.asarray(vec, float)
        if vec.shape[0] == size:
            return vec
        if vec.shape[0] > size:
            raise AltroError(ErrorCode.DIMENSION_MISMATCH,
                             f"cost term of size {vec.shape[0]} > {size}")
        return np.concatenate([vec, np.zeros(size - vec.shape[0])])

    @staticmethod
    def _pad_mat(mat, rows_, cols):
        mat = np.asarray(mat, float)
        if mat.shape == (rows_, cols):
            return mat
        out = np.zeros((rows_, cols))
        out[: mat.shape[0], : mat.shape[1]] = mat
        return out

    def set_quadratic_cost(self, Q, R, H, q, r, c: float = 0.0,
                           k_start: int = 0, k_stop: int = LAST_INDEX):
        self._require_dims()
        rows = self._cost_rows
        for k in self._range(k_start, k_stop, inclusive=True):
            rows["Qfull"][k] = self._pad_mat(Q, self.n, self.n)
            rows["Rfull"][k] = self._pad_mat(R, self.m, self.m)
            rows["H"][k] = self._pad_mat(H, self.m, self.n)
            rows["q"][k] = self._pad_row(np.asarray(q, float), self.n)
            rows["r"][k] = self._pad_row(np.asarray(r, float), self.m)
            rows["c"][k] = c
        self._cost_kind = "quadratic"
        return self

    def set_cost_function(self, stage: Callable, terminal: Callable):
        """Generic JAX-traceable costs: stage(x, u, k), terminal(x).
        (Working generic costs — the reference drops them on the floor,
        knotpoint_data.cpp:112-121.)"""
        self._generic_cost = GenericCost(stage=stage, term=terminal)
        self._cost_kind = "generic"
        return self

    def _wrap_hetero_constraint(self, fn, jac, nk, mk):
        """Slice padded (x, u) down to a knot's own dims for the user's
        constraint callable; embed its Jacobian into the padded frame."""
        n, m = self.n, self.m
        if (nk, mk) == (n, m):
            return fn, jac

        def fn2(x, u, k):
            return fn(x[:nk], u[:mk], k)

        if jac is None:
            return fn2, None

        def jac2(x, u, k):
            J = jac(x[:nk], u[:mk], k)  # [p, nk + mk]
            out = jnp.zeros((J.shape[0], n + m), x.dtype)
            out = out.at[:, :nk].set(J[:, :nk])
            out = out.at[:, n:n + mk].set(J[:, nk:])
            return out

        return fn2, jac2

    def set_constraint(self, fn: Callable, dim: int, cone: Cone, label: str = "",
                       k_start: int = 0, k_stop: int = 0,
                       jacobian: Optional[Callable] = None):
        """fn(x, u, k) -> [dim] (u is zeros at the terminal knot). With
        heterogeneous dims, fn receives the knot's OWN (n_k, m_k)-sized
        state/input (the framework slices the padded vectors)."""
        if dim <= 0:
            raise AltroError(ErrorCode.INVALID_CONSTRAINT_DIM)
        ks = list(self._range(k_start, k_stop, inclusive=True))
        groups = (
            self._dims_groups(ks) if self._hetero else {(self.n, self.m): ks}
        )
        for (nk, mk), knots in groups.items():
            fn_w, jac_w = self._wrap_hetero_constraint(fn, jacobian, nk, mk)
            active = np.zeros(self.N + 1, bool)
            active[knots] = True
            self._constraints.append(
                ConstraintSpec(fn=fn_w, cone=cone, dim=dim,
                               active=jnp.asarray(active), jac=jac_w,
                               label=label)
            )
        return self

    def set_state_bounds(self, x_lo=None, x_hi=None,
                         k_start: int = 0, k_stop: int = LAST_INDEX):
        """Working native bound constraints (masked inequality cone) —
        the reference stubs these out (knotpoint_data.cpp:721-737)."""
        self._require_dims()
        lo = np.full(self.n, -np.inf) if x_lo is None else np.asarray(x_lo, float)
        hi = np.full(self.n, np.inf) if x_hi is None else np.asarray(x_hi, float)
        lo, hi = self._pad_bounds(lo, hi, self.n, k_start, k_stop, True, True)
        if np.any(hi < lo):
            raise AltroError(ErrorCode.INVALID_BOUND_CONSTRAINT)
        return self._bound_constraint(lo, hi, on_state=True, label="state bounds",
                                      k_start=k_start, k_stop=k_stop, inclusive=True)

    def set_input_bounds(self, u_lo=None, u_hi=None,
                         k_start: int = 0, k_stop: int = LAST_INDEX):
        self._require_dims()
        lo = np.full(self.m, -np.inf) if u_lo is None else np.asarray(u_lo, float)
        hi = np.full(self.m, np.inf) if u_hi is None else np.asarray(u_hi, float)
        lo, hi = self._pad_bounds(lo, hi, self.m, k_start, k_stop, False, False)
        if np.any(hi < lo):
            raise AltroError(ErrorCode.INVALID_BOUND_CONSTRAINT)
        return self._bound_constraint(lo, hi, on_state=False, label="input bounds",
                                      k_start=k_start, k_stop=k_stop, inclusive=False)

    def _pad_bounds(self, lo, hi, size, k_start, k_stop, inclusive, on_state):
        """Extend knot-sized bound vectors to the padded max dimension
        (padded coordinates get infinite bounds, i.e. unconstrained).
        Requires uniform dims across the knot range."""
        if lo.shape[0] == size:
            return lo, hi
        ks = list(self._range(k_start, k_stop, inclusive=inclusive))
        dims = {self._knot_dims(k)[0 if on_state else 1] for k in ks}
        if len(dims) != 1 or lo.shape[0] != next(iter(dims)):
            raise AltroError(
                ErrorCode.DIMENSION_MISMATCH,
                "bound vector size must equal the knot dimension (uniform "
                "over the range) or the padded max dimension",
            )
        pad = size - lo.shape[0]
        return (np.concatenate([lo, np.full(pad, -np.inf)]),
                np.concatenate([hi, np.full(pad, np.inf)]))

    def _bound_constraint(self, lo, hi, on_state, label, k_start, k_stop, inclusive):
        finite_hi = np.isfinite(hi)
        finite_lo = np.isfinite(lo)
        hi_f = jnp.asarray(np.where(finite_hi, hi, 0.0), self.dtype)
        lo_f = jnp.asarray(np.where(finite_lo, lo, 0.0), self.dtype)
        mask_hi = jnp.asarray(finite_hi, self.dtype)
        mask_lo = jnp.asarray(finite_lo, self.dtype)
        dim = len(lo)

        def fn(x, u, k):
            v = x if on_state else u
            # Infinite bounds contribute a constant -1 (strictly feasible)
            c_hi = jnp.where(mask_hi > 0, v - hi_f, -1.0)
            c_lo = jnp.where(mask_lo > 0, lo_f - v, -1.0)
            return jnp.concatenate([c_hi, c_lo])

        active = np.zeros(self.N + 1, bool)
        for k in self._range(k_start, k_stop, inclusive=inclusive):
            active[k] = True
        self._constraints.append(
            ConstraintSpec(fn=fn, cone=Cone.NEGATIVE_ORTHANT, dim=2 * dim,
                           active=jnp.asarray(active), label=label,
                           # Jacobian rows are +-e_i: diagonal AL Hessian
                           # AND affine — rides the tiled trial-rollout
                           # kernel's in-kernel AL term
                           diag_hessian=True, affine=True)
        )
        return self

    def set_initial_state(self, x0):
        self._x0 = np.asarray(x0, float)
        if self._problem is not None:
            self._problem = dataclasses.replace(
                self._problem, x0=jnp.asarray(self._x0, self.dtype)
            )
        return self

    def set_options(self, opts: SolverOptions):
        self._opts = opts
        self._solve_fn = None
        return self

    # ------------------------------------------------------ initialization

    def _build_cost(self):
        rows = self._cost_rows
        dt = self.dtype
        if self._hetero:
            # Padded input coordinates get a unit cost diagonal: their
            # B columns and linear costs are zero, so u_pad stays 0, and
            # the unit term keeps Quu positive definite in the Riccati
            # factorization. Padded state coordinates stay at zero cost
            # (P rows vanish there; no factorization involved).
            for k in range(self.N):
                mk = self._knot_dims(k)[1]
                if mk < self.m:
                    rows["R"][k, mk:] = 1.0
                    rr = rows["Rfull"][k]
                    rr[mk:, :] = 0.0
                    rr[:, mk:] = 0.0
                    rr[range(mk, self.m), range(mk, self.m)] = 1.0
        if self._cost_kind == "generic":
            return self._generic_cost
        if self._cost_kind == "quadratic":
            Q = rows["Qfull"].copy()
            R = rows["Rfull"].copy()
            # Knots set via the diagonal API fold into the full matrices
            diag_mask = np.abs(Q).sum(axis=(1, 2)) == 0
            for k in np.where(diag_mask)[0]:
                Q[k] = np.diag(rows["Q"][k])
                R[k] = np.diag(rows["R"][k])
            return QuadraticCost(
                Q=jnp.asarray(Q, dt), R=jnp.asarray(R, dt), H=jnp.asarray(rows["H"], dt),
                q=jnp.asarray(rows["q"], dt), r=jnp.asarray(rows["r"], dt),
                c=jnp.asarray(rows["c"], dt),
            )
        return DiagonalCost(
            Q=jnp.asarray(rows["Q"], dt), R=jnp.asarray(rows["R"], dt),
            q=jnp.asarray(rows["q"], dt), r=jnp.asarray(rows["r"], dt),
            c=jnp.asarray(rows["c"], dt),
        )

    def _wrap_hetero_dynamics(self, f, j, nk, mk, nk1):
        """Pad a (n_k, m_k) -> n_{k+1} dynamics callable to the max dims:
        the wrapped fn slices the real coordinates, calls the user's
        callable, and zero-fills the padded next-state coordinates (they
        carry zero cost and zero Jacobian rows, so they stay inert)."""
        n, m = self.n, self.m
        if (nk, mk, nk1) == (n, m, n):
            return f, j

        def dyn(x, u, h, k):
            xn = f(x[:nk], u[:mk], h, k)
            if nk1 < n:
                xn = jnp.concatenate([xn, jnp.zeros((n - nk1,), x.dtype)])
            return xn

        if j is None:
            return dyn, None

        def jac(x, u, h, k):
            J = j(x[:nk], u[:mk], h, k)  # [nk1, nk + mk]
            out = jnp.zeros((n, n + m), x.dtype)
            out = out.at[:nk1, :nk].set(J[:, :nk])
            out = out.at[:nk1, n:n + mk].set(J[:, nk:])
            return out

        return dyn, jac

    def _build_dynamics(self):
        fns = self._dynamics
        jacs = self._dynamics_jac
        if any(f is None for f in fns):
            raise AltroError(ErrorCode.DYNAMICS_FUN_NOT_SET)
        hetero = self._hetero
        unique = []
        keys = []
        index = np.zeros(self.N, np.int32)
        for k, f in enumerate(fns):
            nk, mk = self._knot_dims(k)
            nk1 = self._knot_dims(k + 1)[0]
            key = (id(f), id(jacs[k]), nk, mk, nk1) if hetero else (id(f), id(jacs[k]))
            for i, kk in enumerate(keys):
                if kk == key:
                    index[k] = i
                    break
            else:
                index[k] = len(unique)
                keys.append(key)
                fk, jk = (
                    self._wrap_hetero_dynamics(f, jacs[k], nk, mk, nk1)
                    if hetero
                    else (f, jacs[k])
                )
                unique.append((fk, jk))
        if len(unique) == 1:
            return unique[0][0], unique[0][1]
        # Per-knot dynamics: dispatch with lax.switch on a static index map
        idx = jnp.asarray(index)

        def dyn(x, u, h, k):
            return jax.lax.switch(idx[k], [f for f, _ in unique], x, u, h, k)

        have_jacs = all(j is not None for _, j in unique)
        if not have_jacs:
            return dyn, None

        def jac(x, u, h, k):
            return jax.lax.switch(idx[k], [j for _, j in unique], x, u, h, k)

        return dyn, jac

    def initialize(self):
        # Precondition checks surface in the reference's order
        # (KnotPointData::Initialize, knotpoint_data.cpp:229-276, pinned by
        # knotpoint_data_test.cpp:71-93): dimensions -> timestep ->
        # dynamics -> cost.
        self._require_dims()
        if self._nk is not None and np.any(self._nk < 0):
            raise AltroError(
                ErrorCode.STATE_DIM_UNKNOWN,
                "set_dimension left knots %s unset"
                % np.where(self._nk < 0)[0].tolist(),
            )
        if self._hetero and self._cost_kind == "generic":
            raise AltroError(
                ErrorCode.DIMENSION_MISMATCH,
                "generic costs are not supported with heterogeneous "
                "dimensions (the framework cannot mask unknown cost terms "
                "on padded coordinates); use diagonal/quadratic costs",
            )
        if np.any(self._h <= 0):
            raise AltroError(ErrorCode.TIMESTEP_NOT_POSITIVE)
        dyn, jac = self._build_dynamics()
        if self._cost_kind is None:
            raise AltroError(ErrorCode.COST_FUN_NOT_SET)
        if self._x0 is None:
            self._x0 = np.zeros(self.n)
        elif self._x0.shape[0] < self.n:
            n0 = self._knot_dims(0)[0]
            if self._x0.shape[0] != n0:
                raise AltroError(ErrorCode.DIMENSION_MISMATCH,
                                 "x0 must match the knot-0 state dimension")
            self._x0 = np.concatenate(
                [self._x0, np.zeros(self.n - self._x0.shape[0])]
            )
        self._problem = Problem(
            N=self.N, n=self.n, m=self.m, dynamics=dyn, dynamics_jac=jac,
            constraints=tuple(self._constraints), cost=self._build_cost(),
            h=jnp.asarray(self._h, self.dtype), x0=jnp.asarray(self._x0, self.dtype),
            dynamics_cols=getattr(self, "_dynamics_cols", None),
        )
        self._state = init_state(self._problem)
        return self

    def is_initialized(self) -> bool:
        return self._problem is not None

    def _require_init(self):
        if not self.is_initialized():
            raise AltroError(ErrorCode.SOLVER_NOT_INITIALIZED)

    # ------------------------------------------------------------- running

    @property
    def problem(self) -> Problem:
        self._require_init()
        return self._problem

    @property
    def state(self) -> SolverState:
        self._require_init()
        return self._state

    def set_state(self, x, k_start: int = 0, k_stop: int = LAST_INDEX):
        self._require_init()
        ks = list(self._range(k_start, k_stop, inclusive=True))
        new_x = self._state.x.at[jnp.asarray(ks)].set(jnp.asarray(x, self.dtype))
        self._state = dataclasses.replace(self._state, x=new_x)
        return self

    def set_input(self, u, k_start: int = 0, k_stop: int = LAST_INDEX):
        self._require_init()
        ks = list(self._range(k_start, k_stop, inclusive=False))
        new_u = self._state.u.at[jnp.asarray(ks)].set(jnp.asarray(u, self.dtype))
        self._state = dataclasses.replace(self._state, u=new_u)
        return self

    def set_dual_dynamics(self, y, k_start: int = 0, k_stop: int = LAST_INDEX):
        """Warm-start the TVLQR duals (SetDualDynamics, altro_solver.hpp:348)."""
        self._require_init()
        ks = list(self._range(k_start, k_stop, inclusive=True))
        new_y = self._state.y.at[jnp.asarray(ks)].set(jnp.asarray(y, self.dtype))
        self._state = dataclasses.replace(self._state, y=new_y)
        return self

    def set_dual_constraint(self, constraint_index: int, z,
                            k_start: int = 0, k_stop: int = LAST_INDEX):
        """Warm-start a constraint group's AL duals (SetDualGeneric,
        altro_solver.hpp:357 — declared-but-missing in the reference)."""
        self._require_init()
        ks = list(self._range(k_start, k_stop, inclusive=True))
        zs = list(self._state.z)
        zs[constraint_index] = zs[constraint_index].at[jnp.asarray(ks)].set(
            jnp.asarray(z, self.dtype)
        )
        self._state = dataclasses.replace(self._state, z=tuple(zs))
        return self

    def open_loop_rollout(self):
        self._require_init()
        x = open_loop_rollout(self._problem, self._state.u)
        self._state = dataclasses.replace(self._state, x=x)
        return self

    def calc_cost(self) -> float:
        """Objective + AL penalty terms at the current trajectory
        (reference CalcCost, solver.cpp:163-174)."""
        self._require_init()
        return float(
            al_total_cost(self._problem, self._state.x, self._state.u,
                          self._state.z, self._state.rho)
        )

    def solve(self) -> SolveStatus:
        self._require_init()
        if self._solve_fn is None:
            self._solve_fn = jax.jit(_solve, static_argnames=("opts",))
        if self._opts.max_solve_time != float("inf"):
            return self._solve_timed()
        t0 = time.perf_counter()
        state, stats = self._solve_fn(self._problem, self._state, self._opts)
        stats = jax.block_until_ready(stats)
        self._solve_time_ms = (time.perf_counter() - t0) * 1e3
        self._state = state
        self._stats = stats
        status = SolveStatus(int(stats.status))
        if self._opts.throw_errors and status not in _BENIGN_STATUSES:
            raise AltroError(
                _STATUS_ERROR_CODES.get(status, ErrorCode.LINE_SEARCH_FAILED),
                f"solve failed: {status.name}",
            )
        return status

    def _solve_timed(self) -> SolveStatus:
        """Enforce options.max_solve_time (declared but never enforced by
        the reference, solver_options.hpp:36 has no read sites).

        A jitted solve cannot be interrupted mid-flight, so the budget is
        enforced host-side by running the solve in CHUNKS of iterations
        and checking the wall clock between chunks. Continuation chunks
        warm-start from the carried state with the escalated penalty
        kept (penalty_warm_start), so the chunked trajectory follows the
        single-call solve closely (identically for unconstrained
        problems). On budget exhaustion the status is MAX_SOLVE_TIME and
        the best-so-far iterates are kept — deterministic compute budgets
        (rti_mode / iterations_max) remain the recommended real-time
        mechanism.
        """
        chunk = max(1, min(self._opts.iterations_max, 10))
        budget_s = self._opts.max_solve_time
        total_iters = 0
        t0 = time.perf_counter()
        status = SolveStatus.UNSOLVED
        # ONE static options value for every chunk (a static-field flip
        # between chunks would trigger a fresh jit inside the wall-clock
        # budget being enforced): always run chunks with
        # penalty_warm_start=True, and reproduce a cold start's penalty
        # reset by seeding state.rho host-side so that
        # clip(rho * decay, penalty_initial, penalty_max) == penalty_initial.
        opts_chunk = self._opts.replace(
            iterations_max=chunk, max_solve_time=float("inf"),
            throw_errors=False, penalty_warm_start=True,
        )
        if not self._opts.penalty_warm_start:
            decay = self._opts.penalty_warm_start_decay
            seed = self._opts.penalty_initial / decay if decay > 0 else (
                self._opts.penalty_initial
            )
            self._state = dataclasses.replace(
                self._state,
                rho=jnp.full_like(self._state.rho, seed),
            )
        while True:
            state, stats = self._solve_fn(self._problem, self._state, opts_chunk)
            stats = jax.block_until_ready(stats)
            self._state = state
            self._stats = stats
            total_iters += int(stats.iterations)
            status = SolveStatus(int(stats.status))
            elapsed = time.perf_counter() - t0
            if status not in (
                SolveStatus.MAX_ITERATIONS,
                # benign early-out (reference solver.cpp:451): a later
                # chunk's dual/penalty update can reshape the merit
                # landscape, so keep spending the remaining budget
                SolveStatus.MERIT_FUN_GRADIENT_TOO_SMALL,
            ):
                break  # converged or failed inside the chunk
            if total_iters >= self._opts.iterations_max:
                break  # keeps MAX_ITERATIONS or the final chunk's MFGTS
            if elapsed >= budget_s:
                status = SolveStatus.MAX_SOLVE_TIME
                break
            # continuation chunks reuse opts_chunk verbatim: the escalated
            # penalty is carried through state.rho (penalty_warm_start=True
            # above), so no static field changes and no recompile happens
            # inside the budget
        self._solve_time_ms = (time.perf_counter() - t0) * 1e3
        self._stats = dataclasses.replace(
            self._stats,
            status=jnp.asarray(int(status), jnp.int32),
            iterations=jnp.asarray(total_iters, jnp.int32),
        )
        if self._opts.throw_errors and status not in _BENIGN_STATUSES:
            raise AltroError(
                _STATUS_ERROR_CODES.get(status, ErrorCode.LINE_SEARCH_FAILED),
                f"solve failed: {status.name}",
            )
        return status

    # ------------------------------------------------------------- getters

    def get_state(self, k: int) -> np.ndarray:
        self._require_init()
        return np.asarray(self._state.x[k])[: self._knot_dims(k)[0]]

    def get_input(self, k: int) -> np.ndarray:
        self._require_init()
        return np.asarray(self._state.u[k])[: self._knot_dims(k)[1]]

    def get_dual_dynamics(self, k: int) -> np.ndarray:
        self._require_init()
        return np.asarray(self._state.y[k])

    def get_dual_constraint(self, constraint_index: int, k: int) -> np.ndarray:
        """Augmented-Lagrangian dual of constraint group `constraint_index`
        at knot k (the reference declares dual getters but never defines
        them, altro_solver.hpp:392-401)."""
        self._require_init()
        return np.asarray(self._state.z[constraint_index][k])

    def get_feedback_gain(self, k: int) -> np.ndarray:
        """K_k — declared but unimplemented in the reference
        (altro_solver.hpp:381, no definition)."""
        self._require_init()
        return np.asarray(self._state.K[k])

    def get_feedforward_gain(self, k: int) -> np.ndarray:
        self._require_init()
        return np.asarray(self._state.d[k])

    def get_iterations(self) -> int:
        return int(self._stats.iterations)

    def get_status(self) -> SolveStatus:
        return SolveStatus(int(self._stats.status))

    def get_solve_time_ms(self) -> float:
        return self._solve_time_ms

    def get_final_objective(self) -> float:
        return float(self._stats.objective_value)

    def get_primal_feasibility(self) -> float:
        return float(self._stats.primal_feasibility)

    def get_stationarity(self) -> float:
        return float(self._stats.stationarity)

    @property
    def stats(self):
        return self._stats

    def get_time_step(self, k: int) -> float:
        return float(self._h[k])

    def get_final_time(self) -> float:
        """Total horizon duration (declared-but-missing in the reference,
        altro_solver.hpp:421)."""
        return float(self._h.sum())

    def get_horizon_length(self) -> int:
        return self.N

    def get_state_dim(self, k: Optional[int] = None) -> int:
        """State dimension (of knot k with heterogeneous dims; the padded
        max dimension when k is omitted)."""
        return self.n if k is None else self._knot_dims(k)[0]

    def get_input_dim(self, k: Optional[int] = None) -> int:
        return self.m if k is None else self._knot_dims(k)[1]

    # ----------------------------------------------------------------- MPC

    def update_linear_costs(self, q=None, r=None, c=None,
                            k_start: int = 0, k_stop: int = LAST_INDEX):
        """Slide the linear cost terms (altro_solver.cpp:266-281)."""
        self._require_init()
        if not isinstance(self._problem.cost, (DiagonalCost, QuadraticCost)):
            raise AltroError(ErrorCode.COST_NOT_QUADRATIC)
        cost = self._problem.cost
        ks = jnp.asarray(list(self._range(k_start, k_stop, inclusive=True)))
        kw = {}
        if q is not None:
            kw["q"] = cost.q.at[ks].set(jnp.asarray(q, self.dtype))
        if r is not None:
            kw["r"] = cost.r.at[ks].set(jnp.asarray(r, self.dtype))
        if c is not None:
            kw["c"] = cost.c.at[ks].set(jnp.asarray(c, self.dtype))
        self._problem = dataclasses.replace(
            self._problem, cost=dataclasses.replace(cost, **kw)
        )
        return self

    def update_initial_state(self, x0):
        self._require_init()
        self._problem = dataclasses.replace(
            self._problem, x0=jnp.asarray(x0, self.dtype)
        )
        return self

    def shift_trajectory(self):
        """Warm-start shift (altro_solver.cpp:283-293)."""
        self._require_init()
        from altro_tpu.mpc import shift_trajectory

        self._state = shift_trajectory(self._state)
        return self

    # ------------------------------------------------------------ printing

    def print_state_trajectory(self):
        """Parity: ALTROSolver::PrintStateTrajectory (altro_solver.cpp:464-470)."""
        self._require_init()
        print("STATE TRAJECTORY:")
        for k in range(self.N + 1):
            print(f" x[{k:3d}]: " + np.array2string(np.asarray(self._state.x[k]), precision=4))

    def print_input_trajectory(self):
        self._require_init()
        print("INPUT TRAJECTORY:")
        for k in range(self.N):
            print(f" u[{k:3d}]: " + np.array2string(np.asarray(self._state.u[k]), precision=4))
