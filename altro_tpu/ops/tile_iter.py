"""Tile-resident solver-iteration building blocks.

A batched solve whose pieces disagree on layout pays a relayout of
every per-iteration operand at each boundary, every iteration. The
tile-resident ITERATION avoids that: every consumer of the
per-iteration data — the Riccati backward, the line-search trial
rollouts, the accepted-step completion, the optimality/dual/penalty
bookkeeping — operates on lane-tile arrays (ops/tiles.py), so the
layout NEVER changes inside the solve (edges convert once per solve
call, or once per closed-loop MPC run when the caller keeps its state
tiled).

The batching strategy: per-lane functions (model dynamics, AL cost,
cone projections — any JAX-traceable user callable) are lifted over the
(sublane, lane) tile axes with TRAILING-axis nested vmaps and over the
batch-tile axis leading, so arrays materialize directly in the
[Bt, orig..., 8, 128] layout and XLA never inserts a minor-dim
transpose. Sequential pieces (the Riccati backward, the closed-loop
trial rollouts) are `lax.scan`s whose step is such a lifted per-lane
step and whose carry is a lane-tile state. These are the plain twins of
the GPU kernels (ops/pallas_riccati.py, ops/pallas_rollout_tiled.py):
what the CPU runs, what the kernels are tested against, and what they
are timed against.

Reference loop being made natively batched: SolverImpl::Solve
(/root/reference/src/altro/solver/solver.cpp:414-511) — the reference
runs one solve per call on one thread; here B lanes run in lockstep with
per-lane masking, which is the batched shape of its MPC deployment
(bicycle_test.cpp:302-337 re-solves the same structure per scenario).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from altro_tpu import al
from altro_tpu.tvlqr import tvlqr_backward

__all__ = [
    "tile_vmap",
    "retry_tiled",
    "TileArgs",
    "TiledGains",
    "riccati_backward_tiled",
    "rollout_phi_x_tiled",
    "rollout_grid_tiled",
    "light_from_xstack_tiled",
    "completion_tiled",
    "cost_expansions_tiled",
]


def tile_vmap(f, in_axes, out_axes=0):
    """Lift a per-lane function over lane tiles.

    `in_axes` is a pytree over f's positional args: True = the arg is
    tiled ([Bt, orig..., 8, 128]); None/False = broadcast unbatched.
    Returns g(args...) with outputs [Bt, out..., 8, 128] (out_axes=0 for
    the Bt level; the sublane/lane levels always map to trailing axes).
    """
    lane = jax.tree.map(lambda b: -1 if b else None, in_axes,
                        is_leaf=lambda x: x is None or isinstance(x, bool))
    tile = jax.tree.map(lambda b: 0 if b else None, in_axes,
                        is_leaf=lambda x: x is None or isinstance(x, bool))
    g = jax.vmap(f, in_axes=lane, out_axes=-1)
    g = jax.vmap(g, in_axes=lane, out_axes=-1)
    return jax.vmap(g, in_axes=tile, out_axes=out_axes)


class TiledGains(NamedTuple):
    """Riccati gains in lane-tile layout ([Bt, N, entry..., 8, 128])."""

    K: jnp.ndarray  # [Bt, N, m, n, 8, 128]
    d: jnp.ndarray  # [Bt, N, m, 8, 128]
    P: jnp.ndarray  # [Bt, N+1, n, n, 8, 128]
    p: jnp.ndarray  # [Bt, N+1, n, 8, 128]
    delta_V: jnp.ndarray  # [Bt, 2, 8, 128]
    ok: jnp.ndarray  # [Bt, 8, 128] bool
    fail_index: jnp.ndarray  # [Bt, 8, 128] int32: smallest failing knot, N if ok


def riccati_backward_tiled(A, B, lxx, luu, lx, lu, reg, lux=None,
                           diag_cost=False, symmetrize=False) -> TiledGains:
    """`tvlqr_backward` lifted onto the lane-tile layout.

    Args (lane tiles trailing, batch-tile index leading):
      A: [Bt, N, n, n, 8, 128], B: [Bt, N, n, m, 8, 128],
      lxx: [Bt, N+1, n, n, ...] (or [Bt, N+1, n, ...] when diag_cost),
      luu: [Bt, N, m, m, ...] (or [Bt, N, m, ...] when diag_cost),
      lx: [Bt, N+1, n, ...], lu: [Bt, N, m, ...], reg: [Bt, 8, 128],
      lux: [Bt, N, m, n, ...] or None (zero cross-Hessian).

    The affine dynamics term is zero (the solver's dyn_expansion zeroes
    it). diag_cost is read from lxx's rank by tvlqr_backward; the flag is
    kept so this twin and the GPU kernel share one signature.
    """
    del diag_cost

    def lane(A_, B_, lxx_, luu_, lux_, lx_, lu_, reg_):
        f0 = jnp.zeros((A_.shape[0], A_.shape[1]), A_.dtype)
        return tvlqr_backward(A_, B_, f0, lxx_, luu_, lux_, lx_, lu_, reg_,
                              symmetrize=symmetrize)

    with_lux = lux is not None
    g = tile_vmap(lane, (True, True, True, True, with_lux or None, True,
                         True, True))(A, B, lxx, luu, lux, lx, lu, reg)
    return TiledGains(*g)


class TileArgs(NamedTuple):
    """The tiled iteration's shared argument bundle.

    problem: Problem pytree whose batched leaves are tiled
      ([Bt, orig..., 8, 128]) and whose shared leaves are the plain
      per-lane arrays; prob_axes marks which is which (True = tiled).
    z_axes likewise for the dual tuple.
    """

    problem: object
    prob_axes: object
    z_axes: Tuple[bool, ...]


def _z_at(z_t, z_axes, k, Bt_idx=None):
    """Slice the dual tuple at knot k (tiled leaves carry [Bt, N+1, p, 8, 128])."""
    return tuple(
        (zj[:, k] if b else zj[k]) for zj, b in zip(z_t, z_axes)
    )


def rollout_phi_x_tiled(
    ta: TileArgs, ref_x_t, ref_u_t, K_t, d_t, z_t, rho_t, alpha, x0_t
):
    """Tile-resident minimal trial rollout: (phi, xstack), both tiled.

    The lane-tile analog of solver.merit_rollout_phi_x (reference merit
    rollout, solver.cpp:273-316, value-only): a lax.scan over knots whose
    carry is the tiled state [Bt, n, 8, 128] and whose step is the
    per-lane policy+dynamics+AL-cost step lifted over the tile axes —
    model/cost/cone code never sees the tiles.

    Args: ref_x_t [Bt, N+1, n, 8, 128], ref_u_t [Bt, N, m, 8, 128],
    K_t [Bt, N, m, n, 8, 128], d_t [Bt, N, m, 8, 128], z_t per group
    [Bt, N+1, p, 8, 128] (or unbatched [N+1, p]), rho_t [Bt, 8, 128],
    alpha scalar or [Bt, 8, 128], x0_t [Bt, n, 8, 128].
    Returns (phi [Bt, 8, 128], xstack [Bt, N+1, n, 8, 128]).
    """
    problem, prob_axes, z_axes = ta
    N = problem.N
    from altro_tpu.ops.smallmat import mv

    alpha_tiled = hasattr(alpha, "ndim") and alpha.ndim == 3

    def lane_step(prob, k, xr, ur, K_k, d_k, z_k, rho, a, x_k):
        u_k = ur - mv(K_k, x_k - xr) + a * d_k
        x_next = prob.dyn_step(k, x_k, u_k)
        cost_k, _, _ = al.al_cost(prob, k, x_k, u_k, z_k, rho, terminal=False)
        return x_next, cost_k

    step_t = tile_vmap(
        lane_step,
        (prob_axes, None, True, True, True, True, z_axes, True,
         True if alpha_tiled else None, True),
    )

    def lane_term(prob, zN, rho, xN):
        cost_N, _, _ = al.al_cost(prob, N, xN, None, zN, rho, terminal=True)
        return cost_N

    term_t = tile_vmap(lane_term, (prob_axes, z_axes, True, True))

    ks = jnp.arange(N, dtype=jnp.int32)
    # knot-leading streams for the scan: major-dim swap only, the (8,128)
    # minor tiles stay contiguous (cheap, unlike the batch-major relayout)
    xr_s = jnp.swapaxes(ref_x_t[:, :N], 0, 1)
    ur_s = jnp.swapaxes(ref_u_t, 0, 1)
    K_s = jnp.swapaxes(K_t, 0, 1)
    d_s = jnp.swapaxes(d_t, 0, 1)
    z_s = tuple(
        jnp.swapaxes(zj[:, :N], 0, 1) if b else zj[:N]
        for zj, b in zip(z_t, z_axes)
    )

    def step(carry, inp):
        x_k, phi = carry
        k, xr, ur, Kk, dk, zk = inp
        x_next, cost_k = step_t(problem, k, xr, ur, Kk, dk, zk, rho_t,
                                alpha, x_k)
        return (x_next, phi + cost_k), x_k

    phi0 = jnp.zeros(x0_t.shape[:1] + x0_t.shape[-2:], x0_t.dtype)
    (x_N, phi), x_st = jax.lax.scan(
        step, (x0_t, phi0), (ks, xr_s, ur_s, K_s, d_s, z_s)
    )
    zN = tuple((zj[:, N] if b else zj[N]) for zj, b in zip(z_t, z_axes))
    phi = phi + term_t(problem, zN, rho_t, x_N)
    xstack = jnp.concatenate(
        [jnp.swapaxes(x_st, 0, 1), x_N[:, None]], axis=1
    )
    return phi, xstack


def rollout_grid_tiled(
    ta: TileArgs, ref_x_t, ref_u_t, K_t, d_t, z_t, rho_t, alphas, x0_t
):
    """Trial grid: vmap `rollout_phi_x_tiled` over the alpha axis.

    alphas: [W]. Returns (phis [W, Bt, 8, 128],
    xstacks [W, Bt, N+1, n, 8, 128]). The grid rides a leading axis of
    the tiled arrays (the batch-major path rode the batch axis instead);
    the scan itself stays ONE sequential chain of N steps.
    """
    return jax.vmap(
        lambda a: rollout_phi_x_tiled(
            ta, ref_x_t, ref_u_t, K_t, d_t, z_t, rho_t, a, x0_t
        )
    )(alphas)


def select_trial_tiled(passes, alphas, phis, xstacks):
    """Per-lane first-passing-trial selection.

    passes/phis: [W, Bt, 8, 128] (bool/float), alphas: [W],
    xstacks: [W, Bt, N+1, n, 8, 128]. Returns per-lane
    (found [Bt,8,128] bool, k_idx int32, alpha, phi, xstack) — each lane
    takes ITS first passing trial (the batch-major path got this from
    per-lane argmax under vmap; here it is an explicit one-hot blend).
    """
    W = passes.shape[0]
    idx = jnp.argmax(passes, axis=0)  # first True (argmax of bool)
    found = jnp.any(passes, axis=0)
    # Select with where, never 0*x: a non-selected trial whose phi/xstack
    # overflowed to inf/NaN (e.g. an alpha=1 diverging rollout) must not
    # poison the selected lane values through 0*inf = NaN.
    sel = jax.nn.one_hot(idx, W, axis=0, dtype=jnp.bool_)  # [W, Bt, 8, 128]
    phi = jnp.sum(jnp.where(sel, phis, 0), axis=0)
    alpha = jnp.sum(
        jnp.where(sel, alphas.astype(phis.dtype)[:, None, None, None], 0),
        axis=0,
    )
    xsel = jnp.sum(jnp.where(sel[:, :, None, None], xstacks, 0), axis=0)
    return found, idx.astype(jnp.int32), alpha, phi, xsel


def select_best_tiled(alphas, phis, xstacks):
    """Per-lane lowest-merit trial (the best-decrease fallback's
    candidate): same blending as select_trial_tiled but argmin(phi)."""
    W = phis.shape[0]
    # Rank non-finite trials as +inf so argmin lands on the best FINITE
    # trial, and select with where (no 0*inf = NaN poisoning from
    # non-selected diverged trials; see select_trial_tiled).
    phis_f = jnp.where(jnp.isfinite(phis), phis,
                       jnp.asarray(jnp.inf, phis.dtype))
    idx = jnp.argmin(phis_f, axis=0)
    sel = jax.nn.one_hot(idx, W, axis=0, dtype=jnp.bool_)
    phi = jnp.sum(jnp.where(sel, phis_f, 0), axis=0)
    alpha = jnp.sum(
        jnp.where(sel, alphas.astype(phis.dtype)[:, None, None, None], 0),
        axis=0,
    )
    xsel = jnp.sum(jnp.where(sel[:, :, None, None], xstacks, 0), axis=0)
    return alpha, phi, xsel


def light_from_xstack_tiled(
    ta: TileArgs, x_t, ref_x_t, ref_u_t, K_t, d_t, P_t, p_t, z_t, rho_t,
    alpha_t
):
    """Tiled analog of solver.light_from_xstack: rebuild (u, y, convals,
    zproj) knot-parallel from a rolled-out state trajectory.

    All trajectory args [Bt, N(+1), ..., 8, 128]; alpha_t [Bt, 8, 128].
    """
    problem, prob_axes, z_axes = ta
    from altro_tpu.ops.smallmat import mv

    N = problem.N
    ks = jnp.arange(N, dtype=jnp.int32)

    def lane_stage(prob, k, xk, xr, ur, K_k, d_k, P_k, p_k, z_k, rho, a):
        dx = xk - xr
        u_k = ur - mv(K_k, dx) + a * d_k
        y_k = mv(P_k, dx) + p_k
        _, convals_k, zproj_k = al.al_cost(prob, k, xk, u_k, z_k, rho,
                                           terminal=False)
        return u_k, y_k, convals_k, zproj_k

    def lane_term(prob, xN, xrN, PN, pN, zN, rho):
        yN = mv(PN, xN - xrN) + pN
        _, convals_N, zproj_N = al.al_cost(prob, N, xN, None, zN, rho,
                                           terminal=True)
        return yN, convals_N, zproj_N

    # knot level (axis 1 of the tiled arrays), then tile levels
    f = lane_stage
    f = tile_vmap(
        f,
        (prob_axes, None, True, True, True, True, True, True, True,
         z_axes, True, True),
        out_axes=0,
    )
    # knot axis: vmap at axis 1 of tiled args (after the Bt axis)
    f = jax.vmap(
        f,
        in_axes=(None, 0, 1, 1, 1, 1, 1, 1, 1,
                 jax.tree.map(lambda b: 1 if b else 0, ta.z_axes,
                              is_leaf=lambda x: isinstance(x, bool)),
                 None, None),
        out_axes=1,
    )
    u_t, y_st, convals_st, zproj_st = f(
        problem, ks, x_t[:, :N], ref_x_t[:, :N], ref_u_t, K_t, d_t,
        P_t[:, :N], p_t[:, :N],
        tuple((zj[:, :N] if b else zj[:N]) for zj, b in zip(z_t, z_axes)),
        rho_t, alpha_t,
    )
    g = tile_vmap(lane_term, (prob_axes, True, True, True, True, z_axes, True))
    y_N, convals_N, zproj_N = g(
        problem, x_t[:, N], ref_x_t[:, N], P_t[:, N], p_t[:, N],
        tuple((zj[:, N] if b else zj[N]) for zj, b in zip(z_t, z_axes)),
        rho_t,
    )
    y_t = jnp.concatenate([y_st, y_N[:, None]], axis=1)
    convals = tuple(
        jnp.concatenate([cs, cN[:, None]], axis=1)
        for cs, cN in zip(convals_st, convals_N)
    )
    zproj = tuple(
        jnp.concatenate([zs, zN[:, None]], axis=1)
        for zs, zN in zip(zproj_st, zproj_N)
    )
    return u_t, y_t, convals, zproj


def retry_tiled(opts, attempt, reg0_t):
    """Adaptive-regularization retry over the whole tiled batch —
    per-lane semantics identical to the vmapped per-lane while_loop in
    solver.backward_adaptive (lanes already ok keep their gains; only
    failing lanes bump reg and take the recomputed values)."""

    g0 = attempt(reg0_t)

    def cond(c):
        g, _, tries = c
        return jnp.logical_and(tries < opts.reg_max_retries,
                               jnp.any(jnp.logical_not(g.ok)))

    def body(c):
        g, reg_c, tries = c
        need = jnp.logical_not(g.ok)  # [Bt, 8, 128]
        reg_new = jnp.where(
            need,
            jnp.where(reg_c <= 0, opts.reg_min, reg_c * opts.reg_scaling),
            reg_c,
        )
        g2 = attempt(reg_new)

        def sel(old, new):
            mask = need.reshape(
                need.shape[:1] + (1,) * (old.ndim - 3) + need.shape[1:]
            )
            return jnp.where(mask, new, old)

        g_sel = jax.tree.map(sel, g, g2)
        return g_sel, reg_new, tries + 1

    g, reg_used, _ = jax.lax.while_loop(
        cond, body, (g0, reg0_t, jnp.asarray(0, jnp.int32))
    )
    return g, reg_used


def cost_expansions_tiled(ta: TileArgs, x_t, u_t, z_t, rho_t, diag=False):
    """AL cost expansions + total AL cost, tiled, WITHOUT the dynamics
    Jacobians (A/B are carried from the accepted-step completion, exactly
    as the batch-major solver reuses them — the round-2 tiled boundary's
    in-boundary Jacobian recompute was measured pure overhead).

    Returns (lx, lu, lxx, luu, lux_or_None, phi0) tiled; with diag=True
    lxx/luu are diagonals ([.., n, 8, 128]) and lux is None — the
    reference's is_diag fast path (tvlqr.cpp:85-89,125-128) feeding
    riccati_backward_pallas_tiled(diag_cost=True).
    """
    problem, prob_axes, z_axes = ta
    N = problem.N
    ks = jnp.arange(N, dtype=jnp.int32)
    z_knot = jax.tree.map(lambda b: 1 if b else 0, z_axes,
                          is_leaf=lambda x: isinstance(x, bool))

    if diag:
        def lane_stage(prob, k, xk, uk, z_k, rho):
            lx_k, lu_k = al.al_grad(prob, k, xk, uk, z_k, rho, terminal=False)
            lxxd, luud = al.al_hess_diag(prob, k, xk, uk, z_k, rho,
                                         terminal=False)
            cost_k, _, _ = al.al_cost(prob, k, xk, uk, z_k, rho,
                                      terminal=False)
            return lx_k, lu_k, lxxd, luud, cost_k

        def lane_term(prob, xN, zN, rho):
            lxN, _ = al.al_grad(prob, N, xN, None, zN, rho, terminal=True)
            lxxdN, _ = al.al_hess_diag(prob, N, xN, None, zN, rho,
                                       terminal=True)
            costN, _, _ = al.al_cost(prob, N, xN, None, zN, rho,
                                     terminal=True)
            return lxN, lxxdN, costN
    else:
        def lane_stage(prob, k, xk, uk, z_k, rho):
            lx_k, lu_k = al.al_grad(prob, k, xk, uk, z_k, rho, terminal=False)
            lxx_k, luu_k, lux_k = al.al_hess(prob, k, xk, uk, z_k, rho,
                                             terminal=False)
            cost_k, _, _ = al.al_cost(prob, k, xk, uk, z_k, rho,
                                      terminal=False)
            return lx_k, lu_k, lxx_k, luu_k, lux_k, cost_k

        def lane_term(prob, xN, zN, rho):
            lxN, _ = al.al_grad(prob, N, xN, None, zN, rho, terminal=True)
            lxxN, _, _ = al.al_hess(prob, N, xN, None, zN, rho, terminal=True)
            costN, _, _ = al.al_cost(prob, N, xN, None, zN, rho,
                                     terminal=True)
            return lxN, lxxN, costN

    f = tile_vmap(lane_stage, (prob_axes, None, True, True, z_axes, True))
    f = jax.vmap(f, in_axes=(None, 0, 1, 1, z_knot, None), out_axes=1)
    g = tile_vmap(lane_term, (prob_axes, True, z_axes, True))

    zs = tuple((zj[:, :N] if b else zj[:N]) for zj, b in zip(z_t, z_axes))
    zN = tuple((zj[:, N] if b else zj[N]) for zj, b in zip(z_t, z_axes))
    if diag:
        lx_st, lu, lxx_st, luu, cost_st = f(problem, ks, x_t[:, :N], u_t,
                                            zs, rho_t)
        lux = None
    else:
        lx_st, lu, lxx_st, luu, lux, cost_st = f(problem, ks, x_t[:, :N],
                                                 u_t, zs, rho_t)
    lxN, lxxN, costN = g(problem, x_t[:, N], zN, rho_t)
    lx = jnp.concatenate([lx_st, lxN[:, None]], axis=1)
    lxx = jnp.concatenate([lxx_st, lxxN[:, None]], axis=1)
    phi0 = jnp.sum(cost_st, axis=1) + costN
    return lx, lu, lxx, luu, lux, phi0


def completion_tiled(ta: TileArgs, x_t, u_t, z_t, rho_t):
    """Dynamics expansions + AL gradients at the accepted trajectory,
    knot-parallel in tile layout. Returns (A, B, lx, lu) tiled.

    The tiled analog of solver.complete_merit_payload's expansion half
    (armijo-only mode: no dphi sensitivity scan — the next iteration's
    dphi(0) is the backward pass's expected-decrease identity).
    """
    problem, prob_axes, z_axes = ta
    N = problem.N
    ks = jnp.arange(N, dtype=jnp.int32)

    def lane_stage(prob, k, xk, uk, z_k, rho):
        A_k, B_k = prob.dyn_expansion(k, xk, uk)
        lx_k, lu_k = al.al_grad(prob, k, xk, uk, z_k, rho, terminal=False)
        return A_k, B_k, lx_k, lu_k

    def lane_term(prob, xN, zN, rho):
        lxN, _ = al.al_grad(prob, N, xN, None, zN, rho, terminal=True)
        return lxN

    f = tile_vmap(lane_stage, (prob_axes, None, True, True, z_axes, True))
    f = jax.vmap(
        f,
        in_axes=(None, 0, 1, 1,
                 jax.tree.map(lambda b: 1 if b else 0, ta.z_axes,
                              is_leaf=lambda x: isinstance(x, bool)),
                 None),
        out_axes=1,
    )
    A_t, B_t, lx_st, lu_t = f(
        problem, ks, x_t[:, :N], u_t,
        tuple((zj[:, :N] if b else zj[:N]) for zj, b in zip(z_t, z_axes)),
        rho_t,
    )
    g = tile_vmap(lane_term, (prob_axes, True, z_axes, True))
    lx_N = g(
        problem, x_t[:, N],
        tuple((zj[:, N] if b else zj[N]) for zj, b in zip(z_t, z_axes)),
        rho_t,
    )
    lx_t = jnp.concatenate([lx_st, lx_N[:, None]], axis=1)
    return A_t, B_t, lx_t, lu_t
