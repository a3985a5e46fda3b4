"""Natively-batched, tile-resident AL-iLQR solve.

The WHOLE iteration — expansions, Riccati backward, line-search trial
rollouts, accepted-step completion, optimality/dual/penalty bookkeeping
— runs on lane-tile arrays ([Bt, ..., 8, 128], ops/tiles.py), so the
data layout never changes inside the solve. Callers convert once per
solve, or once per closed-loop MPC run by carrying the tiled
`SolverState` across ticks (see `shift_trajectory_tiled` / bench.py).

Semantics contract: `solve_tiled(problem_t, prob_axes, state_t, opts)`
computes the SAME per-lane iterates as `jax.vmap(solve)(...)` with the
supported options (parallel phase-split x-only grid line search,
armijo-only acceptance or RTI mode) — verified by
tests/test_tile_solver.py against the vmapped reference path. Per-lane
code (models, costs, cones) never sees the tiles: every per-knot
computation is lifted with trailing-axis nested vmaps
(ops/tile_iter.tile_vmap), and the sequential pieces are either
lax.scans carrying tiled state or, on a GPU, the two kernels chosen by
`select_kernels`.

Reference loop: SolverImpl::Solve (solver.cpp:414-511), natively
batched; per-lane masking replaces vmap's automatic while_loop batching.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from altro_tpu import al, cones
from altro_tpu.ops import tile_iter as ti
from altro_tpu.ops.pallas_riccati import riccati_backward_pallas_tiled
from altro_tpu.ops.pallas_rollout_tiled import (
    rollout_grid_pallas_tiled,
    rollout_tiled_eligible,
)
from altro_tpu.ops.tiles import batch_to_tiles, tiles_to_batch
from altro_tpu.options import SolverOptions
from altro_tpu.problem import Problem
from altro_tpu.solver import SolverState, SolveStats
from altro_tpu.status import SolveStatus

__all__ = [
    "solve_tiled",
    "state_to_tiles",
    "state_from_tiles",
    "stats_from_tiles",
    "shift_trajectory_tiled",
    "tile_problem",
    "supported_options",
    "TiledKernels",
    "select_kernels",
]


class TiledKernels(NamedTuple):
    """The two knot-sequential pieces of a tiled iteration.

    backward: ops/tile_iter.riccati_backward_tiled's signature.
    rollout: ops/tile_iter.rollout_grid_tiled's signature.
    """

    backward: Callable
    rollout: Callable


# Largest state dimension the kernels are compiled for. Both unroll a
# knot's per-lane algebra into straight-line code (the backward's
# products are O(n^3) instructions per knot): on an H100, Triton
# compiles the n=4 backward in 3-6 s and the quadrotor's n=12 one in
# 869 s, so larger states run the twins.
KERNEL_MAX_STATE_DIM = 4


def select_kernels(platform: str, dtype, n: int) -> TiledKernels:
    """The one place the tiled solve chooses who runs its recursions.

    On a GPU ("gpu") with float32 data and at most KERNEL_MAX_STATE_DIM
    states: the compiled Pallas/Triton kernels (ops/pallas_riccati.py,
    ops/pallas_rollout_tiled.py). Anything else: their plain twins in
    ops/tile_iter, which XLA compiles. solve_tiled passes
    `jax.default_backend()`; the rollout kernel further requires
    `rollout_tiled_eligible`, checked there.
    """
    if (platform == "gpu" and jnp.dtype(dtype) == jnp.float32
            and n <= KERNEL_MAX_STATE_DIM):
        return TiledKernels(riccati_backward_pallas_tiled,
                            rollout_grid_pallas_tiled)
    return TiledKernels(ti.riccati_backward_tiled, ti.rollout_grid_tiled)


# ---------------------------------------------------------------------------
# Edge conversions (once per solve / closed-loop run)
# ---------------------------------------------------------------------------


def _scalar_to_tiles(v):
    """[B] -> [Bt, 8, 128]."""
    return batch_to_tiles(v[:, None])[:, 0]


def _scalar_from_tiles(v):
    """[Bt, 8, 128] -> [B]."""
    return tiles_to_batch(v[..., None, :, :])[:, 0]


def state_to_tiles(state: SolverState) -> SolverState:
    """Batch-major [B, ...] SolverState -> lane-tile layout."""
    return SolverState(
        x=batch_to_tiles(state.x),
        u=batch_to_tiles(state.u),
        y=batch_to_tiles(state.y),
        z=tuple(batch_to_tiles(zj) for zj in state.z),
        rho=_scalar_to_tiles(state.rho),
        K=batch_to_tiles(state.K),
        d=batch_to_tiles(state.d),
        P=batch_to_tiles(state.P),
        p=batch_to_tiles(state.p),
        reg=_scalar_to_tiles(state.reg),
    )


def state_from_tiles(state_t: SolverState) -> SolverState:
    return SolverState(
        x=tiles_to_batch(state_t.x),
        u=tiles_to_batch(state_t.u),
        y=tiles_to_batch(state_t.y),
        z=tuple(tiles_to_batch(zj) for zj in state_t.z),
        rho=_scalar_from_tiles(state_t.rho),
        K=tiles_to_batch(state_t.K),
        d=tiles_to_batch(state_t.d),
        P=tiles_to_batch(state_t.P),
        p=tiles_to_batch(state_t.p),
        reg=_scalar_from_tiles(state_t.reg),
    )


def stats_from_tiles(stats_t: SolveStats) -> SolveStats:
    return jax.tree.map(_scalar_from_tiles, stats_t)


def tile_problem(problem: Problem, prob_axes: Problem) -> Problem:
    """Tile the batched leaves of a Problem ([B, orig...] -> lane tiles);
    prob_axes is a Problem pytree of booleans (True = leaf is batched)."""
    return jax.tree.map(
        lambda leaf, b: batch_to_tiles(leaf) if b else leaf, problem, prob_axes
    )


def shift_trajectory_tiled(state_t: SolverState) -> SolverState:
    """mpc.shift_trajectory on a tiled state (knot axis is axis 1)."""
    x = state_t.x.at[:, :-1].set(state_t.x[:, 1:])
    u = state_t.u.at[:, :-1].set(state_t.u[:, 1:])
    return dataclasses.replace(state_t, x=x, u=u)


def supported_options(opts: SolverOptions) -> bool:
    """True when `solve_tiled` implements this configuration (the headline
    batched-MPC configs). Everything else should go through vmap(solve).
    Options do not choose kernels: the platform does (`select_kernels`)."""
    ls_ok = opts.rti_mode or (
        opts.parallel_linesearch
        and opts.use_backtracking_linesearch
        and opts.ls_phase_split
        and opts.ls_grid_x_only
        and opts.ls_armijo_only
    )
    return (
        ls_ok
        and not opts.parallel_riccati
        and opts.iteration_callback is None
    )


# ---------------------------------------------------------------------------
# Tiled per-iteration pieces beyond ops/tile_iter
# ---------------------------------------------------------------------------


def open_loop_rollout_tiled(ta: ti.TileArgs, u_t, x0_t):
    """Tiled open-loop rollout (solver.open_loop_rollout)."""
    problem = ta.problem
    N = problem.N

    def lane_step(prob, k, u_k, x_k):
        return prob.dyn_step(k, x_k, u_k)

    step_t = ti.tile_vmap(lane_step, (ta.prob_axes, None, True, True))
    ks = jnp.arange(N, dtype=jnp.int32)
    u_s = jnp.swapaxes(u_t, 0, 1)

    def step(x_k, inp):
        k, u_k = inp
        return step_t(problem, k, u_k, x_k), x_k

    x_N, x_st = jax.lax.scan(step, x0_t, (ks, u_s))
    return jnp.concatenate([jnp.swapaxes(x_st, 0, 1), x_N[:, None]], axis=1)


def _trajectory_convals_tiled(ta: ti.TileArgs, x_t, u_t):
    """Per-group constraint values along the tiled trajectory."""
    problem = ta.problem
    N = problem.N
    ks = jnp.arange(N, dtype=jnp.int32)

    def lane_stage(prob, k, xk, uk):
        return al.constraint_values(prob, k, xk, uk)

    def lane_term(prob, xN):
        um = jnp.zeros((prob.m,), xN.dtype)
        return al.constraint_values(prob, prob.N, xN, um)

    f = ti.tile_vmap(lane_stage, (ta.prob_axes, None, True, True))
    f = jax.vmap(f, in_axes=(None, 0, 1, 1), out_axes=1)
    stage = f(problem, ks, x_t[:, :N], u_t)
    g = ti.tile_vmap(lane_term, (ta.prob_axes, True))
    term = g(problem, x_t[:, N])
    return tuple(
        jnp.concatenate([s, t[:, None]], axis=1) for s, t in zip(stage, term)
    )


def _stationarity_tiled(ta: ti.TileArgs, A_t, B_t, lx_t, lu_t, y_t):
    from altro_tpu.solver import stationarity

    f = ti.tile_vmap(stationarity, (True, True, True, True, True))
    return f(A_t, B_t, lx_t, lu_t, y_t)


def _feasibility_tiled(ta: ti.TileArgs, convals):
    from altro_tpu.solver import feasibility

    f = ti.tile_vmap(
        lambda prob, cv: feasibility(prob, cv),
        (ta.prob_axes, tuple(True for _ in convals)),
    )
    return f(ta.problem, convals)


def _complementarity_tiled(ta: ti.TileArgs, convals, z_t):
    from altro_tpu.solver import complementarity

    f = ti.tile_vmap(
        lambda prob, cv, zz: complementarity(prob, cv, zz),
        (ta.prob_axes, tuple(True for _ in convals), tuple(True for _ in z_t)),
    )
    return f(ta.problem, convals, z_t)


def _total_cost_tiled(ta: ti.TileArgs, x_t, u_t):
    from altro_tpu.solver import total_cost

    f = ti.tile_vmap(lambda prob, xx, uu: total_cost(prob, xx, uu),
                     (ta.prob_axes, True, True))
    return f(ta.problem, x_t, u_t)


def _lane_where(mask, a, b):
    """Per-lane select: mask [Bt, 8, 128] broadcast over a/b's middle dims."""
    m = mask.reshape(mask.shape[:1] + (1,) * (a.ndim - 3) + mask.shape[1:])
    return jnp.where(m, a, b)


# ---------------------------------------------------------------------------
# The tiled solve
# ---------------------------------------------------------------------------


class _CarryT(NamedTuple):
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
    A: jnp.ndarray
    B: jnp.ndarray
    iter: jnp.ndarray  # [Bt, 8, 128] int32 (per lane)
    status: jnp.ndarray
    stop: jnp.ndarray  # [Bt, 8, 128] bool
    phi: jnp.ndarray
    alpha: jnp.ndarray
    stat: jnp.ndarray
    feas: jnp.ndarray
    ls_iters: jnp.ndarray
    ls_fails: jnp.ndarray  # [lanes] int32 failed-line-search count (recovery cap)
    bp_fail_index: jnp.ndarray  # [Bt, 8, 128] int32, last backward (N = ok)


def solve_tiled(
    problem_t: Problem,
    prob_axes: Problem,
    state_t: SolverState,
    opts: SolverOptions = SolverOptions(),
):
    """Tile-resident batched solve. Returns (SolverState, SolveStats), both
    in lane-tile layout (scalars-per-lane as [Bt, 8, 128]).

    problem_t: Problem whose batched leaves are tiled; prob_axes marks
    them (True = tiled). problem_t.x0 must be tiled ([Bt, n, 8, 128]).
    state_t: SolverState in lane-tile layout (state_to_tiles).
    Supported opts: see `supported_options` — the batched-MPC headline
    configurations; call sites must route unsupported configs through
    jax.vmap(solve).

    Platform rule: on a GPU with float32 data and n <= 4 states the
    Riccati backward and the line-search trial grid run as compiled
    kernels; elsewhere (the CPU, float64, larger states) as their plain
    XLA twins (`select_kernels`).
    """
    if not supported_options(opts):
        raise ValueError(
            "solve_tiled supports the phase-split x-only armijo-only grid "
            "line search (or rti_mode); use jax.vmap(solve) for other "
            "configurations"
        )
    N = problem_t.N
    dtype = state_t.x.dtype
    z_axes = tuple(True for _ in state_t.z)
    ta = ti.TileArgs(problem_t, prob_axes, z_axes)
    kernels = select_kernels(jax.default_backend(), dtype, problem_t.n)
    backward = kernels.backward
    grid_rollout = (kernels.rollout
                    if rollout_tiled_eligible(problem_t, prob_axes)
                    else ti.rollout_grid_tiled)
    diag = opts.diag_expansion and al.diag_expansion_eligible(problem_t)
    lane_shape = state_t.rho.shape  # [Bt, 8, 128]

    # Prologue (solver.cpp:418-434)
    rho0 = jnp.full(lane_shape, opts.penalty_initial, dtype)
    if opts.penalty_warm_start:
        rho0 = jnp.clip(
            state_t.rho.astype(dtype)
            * jnp.asarray(opts.penalty_warm_start_decay, dtype),
            rho0,
            jnp.asarray(opts.penalty_max, dtype),
        )
    x0_t = problem_t.x0
    x_init = open_loop_rollout_tiled(ta, state_t.u, x0_t)
    convals0 = _trajectory_convals_tiled(ta, x_init, state_t.u)
    A0, B0, _, _ = ti.completion_tiled(ta, x_init, state_t.u, state_t.z, rho0)

    W = int(opts.ls_parallel_width)
    n_blocks = max(1, -(-int(opts.ls_max_iters) // W))
    beta = jnp.asarray(opts.ls_beta_decrease, dtype)
    c1 = jnp.asarray(opts.ls_c1, dtype)
    slack = jnp.asarray(opts.ls_armijo_slack, dtype)

    def _grid_rollout(alphas_w, xc, uc, K, d, z, rho):
        return grid_rollout(ta, xc, uc, K, d, z, rho, alphas_w, x0_t)

    init = _CarryT(
        x=x_init,
        u=state_t.u,
        y=state_t.y,
        z=state_t.z,
        rho=rho0,
        K=state_t.K,
        d=state_t.d,
        P=state_t.P,
        p=state_t.p,
        reg=jnp.full(lane_shape, opts.reg_initial, dtype),
        convals=convals0,
        A=A0,
        B=B0,
        iter=jnp.zeros(lane_shape, jnp.int32),
        status=jnp.full(lane_shape, int(SolveStatus.UNSOLVED), jnp.int32),
        stop=jnp.zeros(lane_shape, bool),
        phi=jnp.zeros(lane_shape, dtype),
        alpha=jnp.zeros(lane_shape, dtype),
        stat=jnp.full(lane_shape, jnp.inf, dtype),
        feas=jnp.full(lane_shape, jnp.inf, dtype),
        ls_iters=jnp.zeros(lane_shape, jnp.int32),
        ls_fails=jnp.zeros(lane_shape, jnp.int32),
        bp_fail_index=jnp.full(lane_shape, N, jnp.int32),
    )

    def lane_active(c: _CarryT):
        return jnp.logical_and(
            jnp.logical_not(c.stop), c.iter < opts.iterations_max
        )

    def cond(c: _CarryT):
        return jnp.any(lane_active(c))

    def body(c: _CarryT):
        active = lane_active(c)

        # 1-2. Expansions + tiled backward with adaptive reg retry
        lx, lu, lxx, luu, lux, phi0 = ti.cost_expansions_tiled(
            ta, c.x, c.u, c.z, c.rho, diag=diag
        )

        def attempt(r_t):
            return backward(
                c.A, c.B, lxx, luu, lx, lu, r_t, lux=lux, diag_cost=diag,
                symmetrize=opts.symmetrize_ctg,
            )

        g, reg_used = ti.retry_tiled(opts, attempt, c.reg)
        bp_failed = jnp.logical_not(g.ok)

        # 3. dphi(0) = expected-decrease identity (per lane)
        dphi0 = g.delta_V[:, 0]
        grad_small = jnp.abs(dphi0) < opts.tol_meritfun_gradient

        # 4. Line search: parallel x-only grid (or RTI full step)
        if opts.rti_mode:
            one = jnp.asarray(1.0, dtype)
            # W=1 grid: the same program as the line-search grid
            phi1, xs1 = _grid_rollout(
                one[None], c.x, c.u, g.K, g.d, c.z, c.rho)
            phi_acc, xsel = phi1[0], xs1[0]
            alpha_acc = jnp.full(lane_shape, 1.0, dtype)
            use_ls = jnp.ones(lane_shape, bool)
            ls_failed = jnp.zeros(lane_shape, bool)
            ls_iters = jnp.ones(lane_shape, jnp.int32)
        else:
            fallback = opts.ls_best_decrease_fallback

            def eval_block(block):
                ks = block * W + jnp.arange(W)
                alphas = beta ** ks.astype(dtype)
                phis, xstacks = _grid_rollout(
                    alphas, c.x, c.u, g.K, g.d, c.z, c.rho
                )
                armijo = phis <= (
                    phi0[None]
                    + c1 * alphas[:, None, None, None] * dphi0[None]
                    + slack * jnp.abs(phi0)[None]
                )
                sel = ti.select_trial_tiled(armijo, alphas, phis, xstacks)
                best = (
                    ti.select_best_tiled(alphas, phis, xstacks)
                    if fallback else ()
                )
                return sel, best

            (found, idx, alpha_acc, phi_acc, xsel), best = eval_block(
                jnp.asarray(0, jnp.int32)
            )
            k_acc = idx
            if fallback:
                balpha, bphi, bx = best
            if n_blocks > 1:
                def bcond(bc):
                    f, blk = bc[0], bc[1]
                    return jnp.logical_and(
                        blk < n_blocks, jnp.any(jnp.logical_not(f))
                    )

                def bbody(bc):
                    if fallback:
                        f, blk, k_a, a_a, p_a, x_a, b_a, b_p, b_x = bc
                    else:
                        f, blk, k_a, a_a, p_a, x_a = bc
                    (f2, idx2, a2, p2, x2), best2 = eval_block(blk)
                    take = jnp.logical_and(jnp.logical_not(f), f2)
                    out = (
                        jnp.logical_or(f, f2),
                        blk + 1,
                        jnp.where(take, blk * W + idx2, k_a),
                        jnp.where(take, a2, a_a),
                        jnp.where(take, p2, p_a),
                        _lane_where(take, x2, x_a),
                    )
                    if fallback:
                        ba2, bp2, bx2 = best2
                        tb = bp2 < b_p
                        out = out + (
                            jnp.where(tb, ba2, b_a),
                            jnp.where(tb, bp2, b_p),
                            _lane_where(tb, bx2, b_x),
                        )
                    return out

                init = (found, jnp.asarray(1, jnp.int32), k_acc, alpha_acc,
                        phi_acc, xsel)
                if fallback:
                    init = init + (balpha, bphi, bx)
                out = jax.lax.while_loop(bcond, bbody, init)
                found, _, k_acc, alpha_acc, phi_acc, xsel = out[:6]
                if fallback:
                    balpha, bphi, bx = out[6:]

            not_descent = dphi0 >= 0
            ls_ok = jnp.logical_and(found, jnp.logical_not(not_descent))
            ls_failed = jnp.logical_and(
                jnp.logical_not(grad_small), jnp.logical_not(ls_ok)
            )
            if fallback:
                # widened final-step acceptance (solver.py parity): no
                # Armijo pass but the best trial decreased the merit —
                # carry that trial; still a failure for status/recovery
                fb = jnp.logical_and(jnp.logical_not(ls_ok), bphi < phi0)
                alpha_acc = jnp.where(fb, balpha, alpha_acc)
                phi_acc = jnp.where(fb, bphi, phi_acc)
                xsel = _lane_where(fb, bx, xsel)
            else:
                fb = jnp.zeros_like(ls_ok)
            use_ls = jnp.logical_and(
                jnp.logical_or(ls_ok, fb), jnp.logical_not(grad_small)
            )
            ls_iters = jnp.where(
                ls_ok, k_acc + 1, opts.ls_max_iters
            ).astype(jnp.int32)
            # stats-visible alpha (solver.py: where(grad_small, 0, ls.alpha)
            # with ls.alpha = where(take, alpha_acc, 0))
            alpha_acc = jnp.where(
                jnp.logical_and(
                    jnp.logical_or(grad_small, not_descent),
                    jnp.logical_not(jnp.logical_and(
                        fb, jnp.logical_not(grad_small))),
                ),
                0.0,
                alpha_acc,
            ).astype(dtype)

        # 5. Accepted payload on the per-lane BLENDED trajectory: failed /
        #    grad-small lanes evaluate at (alpha=0, x=reference), which
        #    reproduces the cached alpha-0 payload exactly (u = u_ref,
        #    y = p, convals/zproj/lx/lu/A/B at the reference point) — same
        #    values as solver._alpha0_merit_out, computed instead of
        #    selected.
        x_m = _lane_where(use_ls, xsel, c.x)
        alpha_m = jnp.where(use_ls, alpha_acc, 0.0).astype(dtype)
        phi_m = jnp.where(use_ls, phi_acc, phi0)
        u_m, y_m, convals_m, zproj_m = ti.light_from_xstack_tiled(
            ta, x_m, c.x, c.u, g.K, g.d, g.P, g.p, c.z, c.rho, alpha_m
        )
        A_m, B_m, lx_m, lu_m = ti.completion_tiled(ta, x_m, u_m, c.z, c.rho)

        # 6. Optimality criteria (solver.cpp:456-469)
        stat = _stationarity_tiled(ta, A_m, B_m, lx_m, lu_m, y_m)
        feas = _feasibility_tiled(ta, convals_m)
        stat_tol = jnp.full(lane_shape, opts.tol_stationarity, dtype)
        if opts.tol_stationarity_rel > 0:
            def lane_scale(lxx_, lu_, y_):
                return jnp.maximum(
                    jnp.maximum(jnp.max(jnp.abs(lxx_)), jnp.max(jnp.abs(lu_))),
                    jnp.max(jnp.abs(y_)),
                )

            scale = ti.tile_vmap(lane_scale, (True, True, True))(
                lx_m, lu_m, y_m
            )
            stat_tol = jnp.maximum(stat_tol, opts.tol_stationarity_rel * scale)
        # Divergence guards (solver.py parity; statically compiled out
        # at the inf defaults)
        x_oob = jnp.zeros(lane_shape, bool)
        u_oob = jnp.zeros(lane_shape, bool)
        obj_exceeded = jnp.zeros(lane_shape, bool)
        if math.isfinite(opts.max_state_value):
            x_oob = jnp.max(jnp.abs(x_m), axis=(1, 2)) > opts.max_state_value
        if math.isfinite(opts.max_input_value):
            u_oob = jnp.max(jnp.abs(u_m), axis=(1, 2)) > opts.max_input_value
        if math.isfinite(opts.max_objective_value):
            obj_exceeded = jnp.logical_or(
                jnp.logical_not(jnp.isfinite(phi_m)),
                phi_m > opts.max_objective_value,
            )
        diverged = jnp.logical_or(
            obj_exceeded, jnp.logical_or(x_oob, u_oob)
        )

        converged = jnp.logical_and(
            jnp.abs(stat) < stat_tol, feas < opts.tol_primal_feasibility
        )
        if opts.enable_cost_tolerance:
            cost_converged = jnp.logical_and(
                jnp.logical_and(
                    c.iter > 0, jnp.abs(c.phi - phi_m) < opts.tol_cost
                ),
                feas < opts.tol_primal_feasibility,
            )
            converged = jnp.logical_or(converged, cost_converged)

        # 7. Adaptive dual/penalty update (solver.cpp:471-489)
        do_dual = stat < jnp.sqrt(jnp.asarray(opts.tol_stationarity, dtype))
        z_new = tuple(
            jnp.where(
                jnp.logical_and(
                    do_dual[:, None, None, :, :],
                    spec.active[None, :, None, None, None],
                ),
                zp,
                zj,
            )
            for spec, zp, zj in zip(problem_t.constraints, zproj_m, c.z)
        )
        do_penalty = jnp.logical_and(do_dual, feas > opts.tol_primal_feasibility)
        rho_new = jnp.where(
            do_penalty,
            jnp.minimum(c.rho * opts.penalty_scaling, opts.penalty_max),
            c.rho,
        )

        # Status chain (solver.py parity): MERIT_FUN_GRADIENT_TOO_SMALL
        # is sticky only while the gradient stays small (reference
        # solver.cpp:242-245,451: benign, the loop keeps iterating).
        grad_small_stat = (
            jnp.zeros(lane_shape, bool) if opts.rti_mode else grad_small
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
            # mirror solver.py's recovery semantics exactly (the
            # vmap-parity contract, tests/test_tile_solver.py): no abort
            # on ls failure, escalated reg for the next backward, sticky
            # LINE_SEARCH_FAILED cleared by a later passing step.
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

        new = _CarryT(
            x=x_m, u=u_m, y=y_m, z=z_new, rho=rho_new,
            K=g.K, d=g.d, P=g.P, p=g.p, reg=reg_used,
            convals=convals_m, A=A_m, B=B_m,
            iter=c.iter + 1, status=status, stop=stop,
            phi=phi_m, alpha=alpha_m, stat=stat, feas=feas,
            ls_iters=ls_iters, ls_fails=ls_fails_new,
            bp_fail_index=g.fail_index.astype(jnp.int32),
        )
        # Per-lane freeze: inactive lanes keep every carried value (the
        # exact semantics of a vmapped lax.while_loop).
        return jax.tree.map(
            lambda nn, oo: _lane_where(active, nn, oo)
            if nn.ndim >= 3
            else jnp.where(active, nn, oo),
            new, c,
        )

    final = jax.lax.while_loop(cond, body, init)

    status = jnp.where(
        jnp.logical_and(
            final.status == int(SolveStatus.UNSOLVED),
            final.iter >= opts.iterations_max,
        ),
        int(SolveStatus.MAX_ITERATIONS),
        final.status,
    ).astype(jnp.int32)

    new_state = SolverState(
        x=final.x, u=final.u, y=final.y, z=final.z, rho=final.rho,
        K=final.K, d=final.d, P=final.P, p=final.p, reg=final.reg,
    )
    stats = SolveStats(
        status=status,
        iterations=final.iter,
        objective_value=_total_cost_tiled(ta, final.x, final.u),
        merit_value=final.phi,
        stationarity=final.stat,
        primal_feasibility=final.feas,
        complementarity=_complementarity_tiled(ta, final.convals, final.z),
        rho=final.rho,
        alpha=final.alpha,
        ls_iterations=final.ls_iters,
        dphi=jnp.full(final.phi.shape, jnp.nan, dtype),
        bp_fail_index=final.bp_fail_index,
    )
    return new_state, stats
