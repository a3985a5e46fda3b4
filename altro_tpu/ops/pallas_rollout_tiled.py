"""GPU kernel (Pallas through Triton): tiled line-search trial-grid rollout.

The plain twin is ops/tile_iter.rollout_grid_tiled: a knot-sequential XLA
scan whose step is the per-lane policy + dynamics + AL-cost step, vmapped
over the W trial step sizes. XLA emits it as a while loop of small
fusions, one launch or more per knot. This kernel runs the whole trial
grid as ONE program launch:

  * one program per (trial, block of lanes): the W trials are
    independent, so they ride the grid beside the lanes — W times the
    programs in flight of the Riccati kernel at the same batch;
  * the knot loop runs inside the program with the state carry in
    registers; per-knot operands are lane-contiguous rows of the
    [Bt, N, entry..., 8, 128] tiles (shared, unbatched leaves are
    loaded as scalars);
  * the user dynamics run in the kernel through the column-form step
    (models/tile_steps.py: Problem.dynamics_cols — elementwise on
    per-component lane vectors);
  * the merit (DiagonalCost AL value) accumulates in the kernel; affine
    NEGATIVE_ORTHANT constraint groups add their AL term from per-knot
    coefficient rows extracted once at trace time.

Scope: DiagonalCost; every constraint group declared affine with a
NEGATIVE_ORTHANT cone (bounds / boxes / linear halfspaces) and an
UNBATCHED spec; f32; column-form dynamics present
(`rollout_tiled_eligible`). Everything else keeps the plain scan grid.

Reference parity: the merit rollout loop this fuses is
solver.cpp:273-316 (MeritFunction: closed-loop rollout + AL cost).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from altro_tpu.ops.tiles import LANE, SUB

__all__ = [
    "rollout_tiled_eligible",
    "rollout_grid_pallas_tiled",
    "affine_constraint_stacks",
    "LANES_PER_PROGRAM",
]

# Lanes per program (one lane per thread). Power of two dividing 128.
LANES_PER_PROGRAM = 128


def rollout_tiled_eligible(problem, prob_axes) -> bool:
    """True when the batched trial-grid rollout can run as the kernel:
    column-form dynamics present, DiagonalCost, every constraint group
    affine + NEGATIVE_ORTHANT with an UNBATCHED spec (the affine
    coefficient extraction evaluates the shared per-lane callable)."""
    from altro_tpu.cones import Cone
    from altro_tpu.problem import DiagonalCost

    if problem.dynamics_cols is None:
        return False
    if not isinstance(problem.cost, DiagonalCost):
        return False
    for spec, spec_axes in zip(problem.constraints, prob_axes.constraints):
        if not (spec.affine and spec.cone is Cone.NEGATIVE_ORTHANT):
            return False
        if spec_axes.active:  # batched (per-lane) constraint data
            return False
    return True


def affine_constraint_stacks(problem):
    """Per-knot affine coefficients of the declared-affine constraint
    groups, concatenated over groups:
      cax [N+1, P, n], cau [N+1, P, m], cg [N+1, P], act [N+1, P]
    with c_e(x, u) = cax_e . x + cau_e . u + cg_e exactly (the
    ConstraintSpec.affine contract). Extracted once at trace time by
    evaluating each group's Jacobian/value at (0, 0)."""
    n, m = problem.n, problem.m
    dtype = jnp.float32
    ks = jnp.arange(problem.N + 1, dtype=jnp.int32)
    xz = jnp.zeros((n,), dtype)
    uz = jnp.zeros((m,), dtype)
    AX, AU, G, ACT = [], [], [], []
    for spec in problem.constraints:
        J = jax.vmap(lambda k: spec.jacobian(xz, uz, k))(ks)  # [N+1, p, n+m]
        g = jax.vmap(lambda k: spec.fn(xz, uz, k))(ks)        # [N+1, p]
        AX.append(J[:, :, :n])
        AU.append(J[:, :, n:])
        G.append(g)
        ACT.append(
            jnp.broadcast_to(spec.active[:, None], g.shape).astype(dtype))
    return (jnp.concatenate(AX, axis=1), jnp.concatenate(AU, axis=1),
            jnp.concatenate(G, axis=1), jnp.concatenate(ACT, axis=1))


def _kernel(n, m, P, N, step_cols, *refs):
    """One program = one trial x one block of lanes, all N knots.

    Refs: alphas [W]; x0 [n, L], xref [N+1, n, L], uref [N, m, L],
    K [N, m, n, L], d [N, m, L], rho [L]; cost rows Q, q [N+1, n(, L)],
    R, r [N(+1), m(, L)], c [N+1(, L)], h [N(, L)] — lane-blocked when
    batched, whole shared arrays (scalar loads) when not; with P > 0
    the masked affine rows cax [N+1, P, n], cau [N+1, P, m], cg [N+1, P]
    and the duals z [N+1, P, L]; outputs x [N+1, n, L], phi [L].
    """
    it = iter(refs)
    a_ref, x0_ref, xref_ref, uref_ref, K_ref, d_ref, rho_ref = (
        next(it) for _ in range(7))
    Q_ref, q_ref, R_ref, r_ref, c_ref, h_ref = (next(it) for _ in range(6))
    if P:
        cax_ref, cau_ref, cg_ref, z_ref = (next(it) for _ in range(4))
    x_out_ref, phi_ref = next(it), next(it)

    f32 = jnp.float32
    L = rho_ref.shape[-1]
    alpha = a_ref[pl.program_id(0)]
    rho = rho_ref[:]
    rhoi = 0.5 / rho

    def row(ref, *idx):
        # lane row of a batched leaf (its block keeps a trailing lane
        # axis), or a scalar of a shared one
        if len(ref.shape) == len(idx) + 1:
            return ref[idx + (slice(None),)]
        return ref[idx]

    def al_term(k, x, u):
        # RHOI * sum_e min(0, w_e)^2, w_e = z_e - rho c_e (masked rows:
        # 0 at inactive knots)
        out = jnp.zeros((L,), f32)
        for e in range(P):
            c_e = cg_ref[k, e] + sum(cax_ref[k, e, i] * x[i] for i in range(n))
            if u is not None:
                c_e = c_e + sum(cau_ref[k, e, j] * u[j] for j in range(m))
            w = z_ref[k, e, :] - rho * c_e
            pw = jnp.minimum(w, 0.0)
            out = out + rhoi * pw * pw
        return out

    x0 = tuple(x0_ref[i, :] for i in range(n))

    def body(k, carry):
        x, ph = carry
        dx = [x[i] - xref_ref[k, i, :] for i in range(n)]
        u = [
            uref_ref[k, j, :] + alpha * d_ref[k, j, :]
            - sum(K_ref[k, j, i, :] * dx[i] for i in range(n))
            for j in range(m)
        ]
        ph = (
            ph
            + 0.5 * sum(row(Q_ref, k, i) * x[i] * x[i] for i in range(n))
            + sum(row(q_ref, k, i) * x[i] for i in range(n))
            + 0.5 * sum(row(R_ref, k, j) * u[j] * u[j] for j in range(m))
            + sum(row(r_ref, k, j) * u[j] for j in range(m))
            + row(c_ref, k)
        )
        if P:
            ph = ph + al_term(k, x, u)
        for i in range(n):
            x_out_ref[k, i, :] = x[i]
        x_next = step_cols(tuple(x), tuple(u), row(h_ref, k))
        return tuple(jnp.broadcast_to(xi, (L,)) for xi in x_next), ph

    x, ph = jax.lax.fori_loop(0, N, body, (x0, jnp.zeros((L,), f32)))
    ph = (
        ph
        + 0.5 * sum(row(Q_ref, N, i) * x[i] * x[i] for i in range(n))
        + sum(row(q_ref, N, i) * x[i] for i in range(n))
        + row(c_ref, N)
    )
    if P:
        ph = ph + al_term(N, x, None)
    for i in range(n):
        x_out_ref[N, i, :] = x[i]
    phi_ref[:] = ph


def rollout_grid_pallas_tiled(ta, ref_x_t, ref_u_t, K_t, d_t, z_t, rho_t,
                              alphas, x0_t, interpret=False):
    """Tiled batched trial-grid rollout as one GPU kernel launch.

    Same contract as ops/tile_iter.rollout_grid_tiled: returns
    (phis [W, Bt, 8, 128], xstacks [W, Bt, N+1, n, 8, 128]). Caller
    gates on `rollout_tiled_eligible`. interpret=True runs the kernel in
    the Pallas interpreter (tests on the CPU).
    """
    problem, prob_axes, z_axes = ta
    N, n, m = problem.N, problem.n, problem.m
    W = int(alphas.shape[0])
    bt = x0_t.shape[0]
    dtype = x0_t.dtype
    cost, cost_axes = problem.cost, prob_axes.cost
    L = LANES_PER_PROGRAM
    T = (SUB, LANE)
    f32 = jnp.float32

    def lane_spec(*lead):
        # [Bt, lead..., 8, 128] -> block (lead..., L) of lanes
        nl = len(lead)
        return pl.BlockSpec(
            (None,) + lead + (None, L),
            lambda w, b, s, l, nl=nl: (b,) + (0,) * nl + (s, l))

    def whole_spec(shape):
        nd = len(shape)
        return pl.BlockSpec(shape, lambda w, b, s, l, nd=nd: (0,) * nd)

    def leaf(x, batched):
        x = jnp.asarray(x, f32)
        if batched:
            return x, lane_spec(*x.shape[1:-2])
        return x, whole_spec(x.shape)

    operands = [
        (jnp.asarray(alphas, f32), whole_spec((W,))),
        leaf(x0_t, True), leaf(ref_x_t, True), leaf(ref_u_t, True),
        leaf(K_t, True), leaf(d_t, True), leaf(rho_t, True),
        leaf(cost.Q, cost_axes.Q), leaf(cost.q, cost_axes.q),
        leaf(cost.R, cost_axes.R), leaf(cost.r, cost_axes.r),
        leaf(cost.c, cost_axes.c), leaf(problem.h, prob_axes.h),
    ]
    P = sum(spec.dim for spec in problem.constraints)
    if P:
        cax, cau, cg, act = affine_constraint_stacks(problem)
        z_cat = jnp.concatenate(
            [zj if b else jnp.broadcast_to(
                zj[None, :, :, None, None], (bt,) + zj.shape + T)
             for zj, b in zip(z_t, z_axes)],
            axis=2,
        )
        operands += [
            leaf(cax * act[:, :, None], False),
            leaf(cau * act[:, :, None], False),
            leaf(cg * act, False),
            leaf(z_cat * act[None, :, :, None, None], True),
        ]
    in_arrays, in_specs = zip(*operands)

    out_shapes = (
        jax.ShapeDtypeStruct((W, bt, N + 1, n) + T, f32),   # x knots 0..N
        jax.ShapeDtypeStruct((W, bt) + T, f32),             # phi
    )
    out_specs = (
        pl.BlockSpec((None, None, N + 1, n, None, L),
                     lambda w, b, s, l: (w, b, 0, 0, s, l)),
        pl.BlockSpec((None, None, None, L),
                     lambda w, b, s, l: (w, b, s, l)),
    )
    kern = functools.partial(_kernel, n, m, P, N, problem.dynamics_cols)
    xstack, phi = pl.pallas_call(
        kern,
        grid=(W, bt, SUB, LANE // L),
        in_specs=list(in_specs),
        out_specs=out_specs,
        out_shape=out_shapes,
        compiler_params=plgpu.CompilerParams(num_warps=max(1, L // 32),
                                             num_stages=1),
        interpret=interpret,
        name="rollout_grid_tiled",
    )(*in_arrays)
    return phi.astype(dtype), xstack.astype(dtype)
