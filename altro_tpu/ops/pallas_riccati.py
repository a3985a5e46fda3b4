"""GPU kernel (Pallas through Triton): tiled batched Riccati backward pass.

The plain twin is ops/tile_iter.riccati_backward_tiled (`tvlqr_backward`
lifted onto the lane-tile layout), which XLA compiles into a while loop
of small fusions — one launch or more per knot. This kernel runs the
whole N-knot recursion of a block of lanes in ONE program:

  * layout: operands arrive as [Bt, N, entry..., 8, 128] lane tiles, so
    one per-knot matrix entry of a block of lanes is one contiguous row
    and every load coalesces;
  * one program per block of LANES_PER_PROGRAM lanes (one lane per
    thread); the grid is (Bt, 8, 128 / LANES_PER_PROGRAM);
  * the knot loop runs inside the program with the cost-to-go carry
    (P, p) in registers; the knot axis stays out of the block shape
    (Triton block shapes are powers of two) and is indexed in the loop;
  * Cholesky failure is tracked per lane, so a diverged lane cannot
    poison the batch — same contract as `tvlqr_backward`.

Per-operand structure flags cut memory traffic: `with_lux=False` drops
the cross-Hessian and `diag_cost=True` loads lxx/luu as diagonals — the
reference's `is_diag` fast path (tvlqr.cpp:85-89,125-128).

The math is the recursion of altro_tpu.tvlqr.tvlqr_backward
(== reference tvlqr.cpp:124-191), with the cost-to-go update in its
Cholesky-identity form (symmetric by construction).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from altro_tpu.ops.tile_iter import TiledGains
from altro_tpu.ops.tiles import LANE, SUB

__all__ = ["riccati_backward_pallas_tiled", "LANES_PER_PROGRAM"]

# Lanes per program (one lane per thread). Power of two dividing 128.
LANES_PER_PROGRAM = 128


def _kernel(n, m, N, diag_cost, with_lux, *refs):
    """One program = one block of lanes, all N knots, backward.

    Refs (lane block trailing, batch-tile and sublane axes squeezed):
    A [N, n, n, L], B [N, n, m, L], lxx [N+1, n(, n), L],
    luu [N, m(, m), L], [lux [N, m, n, L]], lx [N+1, n, L], lu [N, m, L],
    reg [L]; outputs K [N, m, n, L], d [N, m, L], P [N, n, n, L],
    p [N, n, L], dV [2, L], flags [2, L] (ok, smallest failing knot).
    """
    it = iter(refs)
    A_ref, B_ref, lxx_ref, luu_ref = next(it), next(it), next(it), next(it)
    lux_ref = next(it) if with_lux else None
    lx_ref, lu_ref, reg_ref = next(it), next(it), next(it)
    K_ref, d_ref, P_ref, p_ref, dV_ref, flags_ref = (
        next(it), next(it), next(it), next(it), next(it), next(it))

    f32 = jnp.float32
    L = reg_ref.shape[-1]
    reg = reg_ref[:]

    def cost_at(ref, k, i, j):
        if diag_cost:
            return ref[k, i, :] if i == j else None
        return ref[k, i, j, :]

    zero = jnp.zeros((L,), f32)
    P_N = tuple(
        tuple(zero if cost_at(lxx_ref, N, i, j) is None
              else cost_at(lxx_ref, N, i, j) for j in range(n))
        for i in range(n))
    p_N = tuple(lx_ref[N, i, :] for i in range(n))
    init = (P_N, p_N, zero, zero, jnp.ones((L,), f32), jnp.full((L,), N, f32))

    def body(t, carry):
        Pn, pn, dV0, dV1, ok_run, fail = carry
        k = N - 1 - t
        a = [[A_ref[k, i, j, :] for j in range(n)] for i in range(n)]
        b = [[B_ref[k, i, j, :] for j in range(m)] for i in range(n)]

        # AtP = A^T P', BtP = B^T P'
        AtP = [[sum(a[l][i] * Pn[l][j] for l in range(n)) for j in range(n)]
               for i in range(n)]
        BtP = [[sum(b[l][i] * Pn[l][j] for l in range(n)) for j in range(n)]
               for i in range(m)]

        def plus(base, extra):
            return extra if base is None else base + extra

        Qxx = [[plus(cost_at(lxx_ref, k, i, j),
                     sum(AtP[i][l] * a[l][j] for l in range(n)))
                for j in range(n)] for i in range(n)]
        Quu = [[plus(cost_at(luu_ref, k, i, j),
                     sum(BtP[i][l] * b[l][j] for l in range(n)))
                for j in range(m)] for i in range(m)]
        Qux = [[plus(lux_ref[k, i, j, :] if with_lux else None,
                     sum(BtP[i][l] * a[l][j] for l in range(n)))
                for j in range(n)] for i in range(m)]
        Qx = [lx_ref[k, i, :] + sum(a[l][i] * pn[l] for l in range(n))
              for i in range(n)]
        Qu = [lu_ref[k, i, :] + sum(b[l][i] * pn[l] for l in range(n))
              for i in range(m)]

        # Unrolled Cholesky of Quu + reg I, per lane
        Lc = [[None] * m for _ in range(m)]
        ok_knot = jnp.ones((L,), f32)
        for j in range(m):
            diag = Quu[j][j] + reg
            for kk in range(j):
                diag = diag - Lc[j][kk] * Lc[j][kk]
            ok_knot = ok_knot * (diag > 0.0).astype(f32)
            ljj = jnp.sqrt(jnp.maximum(diag, 1e-30))
            Lc[j][j] = ljj
            inv = 1.0 / ljj
            for i in range(j + 1, m):
                s = Quu[i][j]
                for kk in range(j):
                    s = s - Lc[i][kk] * Lc[j][kk]
                Lc[i][j] = s * inv
        ok_run = ok_run * ok_knot
        # smallest failing knot: the loop visits decreasing k, so the
        # last overwrite wins (== the min); N when no failure. Carried
        # in f32, exact for N < 2**24.
        fail = jnp.where(ok_knot < 0.5, k.astype(f32), fail)
        # select, never multiply: a failed factorization can overflow to
        # inf and 0*inf = NaN would poison the carry; where() gives the
        # scan's semantics (tvlqr.py: K_k = where(ok_k, sol, 0))
        okb = ok_knot > 0.5

        def chol_solve(cols):
            y = list(cols)
            for i in range(m):
                s = y[i]
                for kk in range(i):
                    s = s - Lc[i][kk] * y[kk]
                y[i] = s / Lc[i][i]
            for i in reversed(range(m)):
                s = y[i]
                for kk in range(i + 1, m):
                    s = s - Lc[kk][i] * y[kk]
                y[i] = s / Lc[i][i]
            return y

        Kk = [[None] * n for _ in range(m)]
        for j in range(n):
            col = chol_solve([Qux[i][j] for i in range(m)])
            for i in range(m):
                Kk[i][j] = jnp.where(okb, col[i], 0.0)
                K_ref[k, i, j, :] = Kk[i][j]
        dk = chol_solve([-Qu[i] for i in range(m)])
        dk = [jnp.where(okb, dk[i], 0.0) for i in range(m)]
        for i in range(m):
            d_ref[k, i, :] = dk[i]

        # Cost-to-go via the Cholesky identity: (Quu + reg I)K = Qux and
        # (Quu + reg I)d = -Qu give
        #   P = Qxx - Qux'K - reg K'K;  p = Qx + Qux'd + reg K'd
        # with Qux'K symmetric by value — upper triangle only, mirrored.
        P_new = [[None] * n for _ in range(n)]
        for i in range(n):
            for j in range(i, n):
                S = sum(Kk[l][i] * Qux[l][j] for l in range(m))
                KtK = sum(Kk[l][i] * Kk[l][j] for l in range(m))
                Pk = Qxx[i][j] - S - reg * KtK
                P_new[i][j] = P_new[j][i] = Pk
                P_ref[k, i, j, :] = Pk
                if i != j:
                    P_ref[k, j, i, :] = Pk
        p_new = []
        for i in range(n):
            pk = (Qx[i]
                  + sum(Qux[l][i] * dk[l] for l in range(m))
                  + reg * sum(Kk[l][i] * dk[l] for l in range(m)))
            p_new.append(pk)
            p_ref[k, i, :] = pk

        # Expected decrease: d'Qu and 0.5 d'Quu d, with
        # Quu d = -Qu - reg d from the same identity
        dQu = sum(dk[i] * Qu[i] for i in range(m))
        dd = sum(dk[i] * dk[i] for i in range(m))
        dV0 = dV0 + dQu
        dV1 = dV1 - 0.5 * (dQu + reg * dd)
        return (tuple(tuple(r) for r in P_new), tuple(p_new), dV0, dV1,
                ok_run, fail)

    _, _, dV0, dV1, ok_run, fail = jax.lax.fori_loop(0, N, body, init)
    dV_ref[0, :] = dV0
    dV_ref[1, :] = dV1
    flags_ref[0, :] = ok_run
    flags_ref[1, :] = fail


@functools.partial(jax.jit, static_argnames=("diag_cost", "interpret"))
def _run(A, B, lxx, luu, lux, lx, lu, reg, diag_cost=False, interpret=False):
    bt, N, n = A.shape[0], A.shape[1], A.shape[2]
    m = B.shape[3]
    with_lux = lux is not None
    L = LANES_PER_PROGRAM
    grid = (bt, SUB, LANE // L)

    def spec(*lead):
        # [Bt, lead..., 8, 128] -> block (lead..., L) of lanes
        nlead = len(lead)
        return pl.BlockSpec(
            (None,) + lead + (None, L),
            lambda b, s, l, nlead=nlead: (b,) + (0,) * nlead + (s, l),
        )

    cost_x = (n,) if diag_cost else (n, n)
    cost_u = (m,) if diag_cost else (m, m)
    in_arrays = [A, B, lxx, luu]
    in_specs = [spec(N, n, n), spec(N, n, m), spec(N + 1, *cost_x),
                spec(N, *cost_u)]
    if with_lux:
        in_arrays.append(lux)
        in_specs.append(spec(N, m, n))
    in_arrays += [lx, lu, reg]
    in_specs += [spec(N + 1, n), spec(N, m), spec()]

    T = (SUB, LANE)
    f32 = jnp.float32
    out_shapes = (
        jax.ShapeDtypeStruct((bt, N, m, n) + T, f32),      # K
        jax.ShapeDtypeStruct((bt, N, m) + T, f32),         # d
        jax.ShapeDtypeStruct((bt, N, n, n) + T, f32),      # P (0..N-1)
        jax.ShapeDtypeStruct((bt, N, n) + T, f32),         # p (0..N-1)
        jax.ShapeDtypeStruct((bt, 2) + T, f32),            # dV
        jax.ShapeDtypeStruct((bt, 2) + T, f32),            # flags
    )
    out_specs = (spec(N, m, n), spec(N, m), spec(N, n, n), spec(N, n),
                 spec(2), spec(2))
    kern = functools.partial(_kernel, n, m, N, diag_cost, with_lux)
    K, d, P_st, p_st, dV, flags = pl.pallas_call(
        kern,
        grid=grid,
        out_shape=out_shapes,
        in_specs=in_specs,
        out_specs=out_specs,
        compiler_params=plgpu.CompilerParams(num_warps=max(1, L // 32),
                                             num_stages=1),
        interpret=interpret,
        name="riccati_backward_tiled",
    )(*in_arrays)
    lxxT = lxx[:, N:]
    if diag_cost:
        # expand the diagonal terminal cost to the dense P_N block
        eye = jnp.eye(n, dtype=lxxT.dtype)[None, None, :, :, None, None]
        PN = lxxT[:, :, :, None] * eye  # [bt, 1, n, n, 8, 128]
    else:
        PN = lxxT
    P = jnp.concatenate([P_st, PN], axis=1)
    p = jnp.concatenate([p_st, lx[:, N:]], axis=1)
    return (K, d, P, p, dV, flags[:, 0] > 0.5, flags[:, 1].astype(jnp.int32))


def riccati_backward_pallas_tiled(A, B, lxx, luu, lx, lu, reg, lux=None,
                                  diag_cost=False, symmetrize=False,
                                  interpret=False) -> TiledGains:
    """Tiled batched Riccati backward pass as one GPU kernel.

    Same signature and result as ops/tile_iter.riccati_backward_tiled
    (float32 operands, [Bt, N(+1), entry..., 8, 128]). `symmetrize` is
    accepted and ignored: the Cholesky-identity update is symmetric by
    construction. interpret=True runs the kernel in the Pallas
    interpreter (tests on the CPU).
    """
    del symmetrize
    f32 = jnp.float32
    args = [jnp.asarray(x, f32) for x in (A, B, lxx, luu)]
    lux = None if lux is None else jnp.asarray(lux, f32)
    return TiledGains(*_run(
        *args, lux, jnp.asarray(lx, f32), jnp.asarray(lu, f32),
        jnp.asarray(reg, f32), diag_cost=diag_cost, interpret=interpret))
