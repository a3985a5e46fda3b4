"""Time-varying LQR: Riccati backward pass and affine closed-loop rollout.

Batched redesign of the reference TVLQR kernel
(/root/reference/src/tvlqr/tvlqr.cpp:65-248). The reference iterates a
serial C loop over arrays-of-pointers per knot point; here the problem
data are struct-of-arrays `[N, ...]` stacks and the recurrences are
`lax.scan`s, so the whole pass is one fused XLA computation that batches
trivially under `vmap` (the batched-MPC axis) and shards over a device
mesh. Inputs of any floating dtype are supported; f64 is used by the
correctness suite, f32 by the performance configuration.

Failure semantics: instead of aborting with the failing knot index
(tvlqr.cpp:162-164), the backward pass records per-lane `ok` and
`fail_index` and returns well-defined (zero-gain) output at failed knots,
so a diverged lane cannot poison a batch; the solver wraps this with an
adaptive regularization retry loop (the reference's unused `reg` hook,
solver.cpp:363, made real).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from altro_tpu.ops.smallmat import lu_solve_small, mm, mtm, mtv, mv, psd_solve_small


def _unroll(N: int) -> int:
    """Scan unroll factor: amortize loop bookkeeping over several tiny
    step bodies (the per-knot blocks are far below an accelerator op's
    granularity).
    Cap with ALTRO_SCAN_UNROLL (e.g. 1 for fast compiles in test suites)."""
    import os

    cap = int(os.environ.get("ALTRO_SCAN_UNROLL", "6"))
    for k in (6, 5, 4, 3, 2):
        if k <= cap and N % k == 0:
            return k
    return 1

__all__ = [
    "TVLQRGains",
    "tvlqr_backward",
    "tvlqr_forward",
    "tvlqr_backward_associative",
    "tvlqr_forward_associative",
]


class TVLQRGains(NamedTuple):
    K: jnp.ndarray  # [N, m, n] feedback gains
    d: jnp.ndarray  # [N, m] feedforward
    P: jnp.ndarray  # [N+1, n, n] cost-to-go Hessian
    p: jnp.ndarray  # [N+1, n] cost-to-go gradient
    delta_V: jnp.ndarray  # [2] expected decrease (d.Qu, 0.5 d.Quu d) sums
    ok: jnp.ndarray  # [] bool: all Cholesky factorizations succeeded
    fail_index: jnp.ndarray  # [] int32: smallest failing knot index, N if ok


def _psd_solve(chol, rhs):
    """Solve (L L^T) X = rhs given lower-triangular L."""
    y = jax.scipy.linalg.solve_triangular(chol, rhs, lower=True)
    return jax.scipy.linalg.solve_triangular(chol.T, y, lower=False)


def tvlqr_backward(A, B, f, lxx, luu, lux, lx, lu, reg=0.0,
                   symmetrize: bool = False) -> TVLQRGains:
    """Riccati backward pass.

    symmetrize: re-symmetrize the cost-to-go each step. Roundoff
    asymmetry compounds over long horizons (material in f32 beyond
    N ~ 100; below test tolerances in f64) but the per-step transposes
    cost throughput at reference scale — so it is opt-in
    (SolverOptions.symmetrize_ctg).

    Diagonal-cost fast path (the reference's `is_diag`,
    tvlqr.cpp:85-89,125-128): pass lxx as [N+1, n] and luu as [N, m]
    diagonals with lux=None — the dense [.., n, n] Hessian stacks are
    never materialized and the cross term is dropped. Selected by shape
    at trace time; results identical to the dense call.

    Args:
      A: [N, n, n] dynamics state Jacobians.
      B: [N, n, m] dynamics input Jacobians.
      f: [N, n] affine terms of the dynamics expansion (zero for a
         defect-free iLQR expansion; the affine dynamics term for TVLQR).
      lxx: [N+1, n, n] cost Hessian wrt state (row N = terminal), or
         [N+1, n] diagonals (diag fast path).
      luu: [N, m, m] (or [N, m] diagonals), lux: [N, m, n] or None.
      lx: [N+1, n], lu: [N, m]: cost gradients.
      reg: scalar added to the Quu diagonal before factorization.

    Returns:
      TVLQRGains. Action-value recursion matches
      /root/reference/src/tvlqr/tvlqr.cpp:124-191:
        Qxx = lxx + A'P⁺A;  Quu = luu + B'P⁺B;  Qux = lux + B'P⁺A
        Qx  = lx + A'(P⁺f + p⁺);  Qu = lu + B'(P⁺f + p⁺)
        K   = (Quu+reg I)⁻¹ Qux;  d = -(Quu+reg I)⁻¹ Qu
        P   = Qxx + K'QuuK - K'Qux - Qux'K
        p   = Qx - K'Quu d - K'Qu + Qux'd
        ΔV += (d·Qu, ½ d·Quu d)
    """
    N = A.shape[0]
    n = A.shape[1]
    m = B.shape[2]
    dtype = A.dtype
    reg = jnp.asarray(reg, dtype)
    diag_cost = lxx.ndim == 2  # [N+1, n] diagonals instead of [N+1, n, n]
    if diag_cost and lux is not None:
        raise ValueError("diagonal-cost fast path has no cross Hessian; pass lux=None")

    P_term = jnp.diag(lxx[N]) if diag_cost else lxx[N]
    p_term = lx[N]
    if lux is None:
        # diag path: placeholder stream (unused); dense path: zero cross
        lux = jnp.zeros((N, 0) if diag_cost else (N, m, n), dtype)

    def step(carry, inputs):
        P_next, p_next = carry
        A_k, B_k, f_k, lxx_k, luu_k, lux_k, lx_k, lu_k = inputs

        AtP = mtm(A_k, P_next)
        BtP = mtm(B_k, P_next)
        if diag_cost:
            eye_n = jnp.eye(n, dtype=dtype)
            Qxx = lxx_k * eye_n + mm(AtP, A_k)
            Quu = luu_k * jnp.eye(m, dtype=dtype) + mm(BtP, B_k)
            Qux = mm(BtP, A_k)
        else:
            Qxx = lxx_k + mm(AtP, A_k)
            Quu = luu_k + mm(BtP, B_k)
            Qux = lux_k + mm(BtP, A_k)
        t = mv(P_next, f_k) + p_next
        Qx = lx_k + mtv(A_k, t)
        Qu = lu_k + mtv(B_k, t)

        Quu_reg = Quu + reg * jnp.eye(m, dtype=dtype)
        sol, ok_k = psd_solve_small(
            Quu_reg, jnp.concatenate([Qux, -Qu[:, None]], axis=1)
        )
        K_k = jnp.where(ok_k, sol[:, :n], 0.0)
        d_k = jnp.where(ok_k, sol[:, n], 0.0)

        QuuK = mm(Quu, K_k)
        KtQux = mtm(K_k, Qux)
        P_k = Qxx + mtm(QuuK, K_k) - KtQux - jnp.swapaxes(KtQux, -1, -2)
        if symmetrize:
            P_k = 0.5 * (P_k + jnp.swapaxes(P_k, -1, -2))
        p_k = Qx - mtv(QuuK, d_k) - mtv(K_k, Qu) + mtv(Qux, d_k)

        dV_k = jnp.stack([jnp.dot(d_k, Qu), 0.5 * jnp.dot(d_k, mv(Quu, d_k))])
        return (P_k, p_k), (K_k, d_k, P_k, p_k, dV_k, ok_k)

    inputs = (A, B, f, lxx[:N], luu, lux, lx[:N], lu)
    (_, _), (K, d, P_stack, p_stack, dV_all, ok_all) = jax.lax.scan(
        step, (P_term, p_term), inputs, reverse=True, unroll=_unroll(N)
    )

    P = jnp.concatenate([P_stack, P_term[None]], axis=0)
    p = jnp.concatenate([p_stack, p_term[None]], axis=0)
    delta_V = jnp.sum(dV_all, axis=0)
    ok = jnp.all(ok_all)
    fail_index = jnp.where(
        ok_all, jnp.asarray(N, jnp.int32), jnp.arange(N, dtype=jnp.int32)
    )
    return TVLQRGains(K, d, P, p, delta_V, ok, jnp.min(fail_index))


def tvlqr_forward(A, B, f, K, d, P, p, x0):
    """Affine closed-loop rollout of the LINEARIZED dynamics.

    u_k = d_k - K_k x_k;  x_{k+1} = A_k x_k + B_k u_k + f_k;
    y_k = P_k x_k + p_k (TVLQR dual estimate).

    Parity: /root/reference/src/tvlqr/tvlqr.cpp:197-248.

    Returns (x: [N+1, n], u: [N, m], y: [N+1, n]).
    """
    N = A.shape[0]

    def step(x_k, inputs):
        A_k, B_k, f_k, K_k, d_k, P_k, p_k = inputs
        u_k = d_k - K_k @ x_k
        y_k = P_k @ x_k + p_k
        x_next = A_k @ x_k + B_k @ u_k + f_k
        return x_next, (x_k, u_k, y_k)

    x_N, (x_stack, u, y_stack) = jax.lax.scan(
        step, x0, (A, B, f, K, d, P[:N], p[:N]), unroll=_unroll(N)
    )
    x = jnp.concatenate([x_stack, x_N[None]], axis=0)
    y = jnp.concatenate([y_stack, (P[N] @ x_N + p[N])[None]], axis=0)
    return x, u, y


# ---------------------------------------------------------------------------
# Parallel-in-time (associative scan) variants — O(log N) depth instead of
# O(N). The backward pass follows the temporal-parallelization-of-Riccati
# construction (see PAPERS.md: "The Parallelization of Riccati Recursion",
# Särkkä & García-Fernández's parallel LQT elements): each stage becomes a
# conditional-value-function element (A, b, C, eta, J) with an associative
# composition, suffix-reduced with `lax.associative_scan`; gains are then
# recovered per knot with one vmapped solve (embarrassingly parallel).
# ---------------------------------------------------------------------------


def _combine_value_elements(a, b):
    """Compose element a (earlier span) with element b (later span).

    Elements parameterize V(x_i, x_j) = 0.5 |x_j - A x_i - b|^2_{C^-1}
    + 0.5 x_i' J x_i - eta' x_i (the C-part is a generalized/possibly
    singular quadratic; only (I + C J)^-1 inverses appear).
    """
    Aa, ba, Ca, etaa, Ja = a
    Ab, bb, Cb, etab, Jb = b
    n = Aa.shape[-1]
    eye = jnp.eye(n, dtype=Aa.dtype)

    # (I + Ca Jb)^-1 applied from the left (unrolled small LU: XLA's
    # batched tiny solve dispatches per-element library kernels, which
    # dominated the associative path's cost — docs/PERF.md round 3)
    M = lu_solve_small(eye + Ca @ Jb, jnp.concatenate([Aa, (ba + Ca @ etab)[..., None], Ca], axis=-1))
    M_Aa = M[..., :n]
    M_vec = M[..., n]
    M_Ca = M[..., n + 1 :]

    A = Ab @ M_Aa
    b_out = Ab @ M_vec + bb
    C = Ab @ M_Ca @ Ab.T + Cb

    # (I + Jb Ca)^-1 applied from the left
    N2 = lu_solve_small(
        eye + Jb @ Ca, jnp.concatenate([(etab - Jb @ ba)[..., None], Jb @ Aa], axis=-1)
    )
    eta = Aa.T @ N2[..., 0] + etaa
    J = Aa.T @ N2[..., 1:] + Ja

    C = 0.5 * (C + C.T)
    J = 0.5 * (J + J.T)
    return A, b_out, C, eta, J


def _identity_elements(count, n, dtype):
    """Composition-identity value elements (A=I, b=0, C=0, eta=0, J=0):
    combine(x, id) == combine(id, x) == x (checked in test_parallel_riccati)."""
    return (
        jnp.broadcast_to(jnp.eye(n, dtype=dtype), (count, n, n)),
        jnp.zeros((count, n), dtype),
        jnp.zeros((count, n, n), dtype),
        jnp.zeros((count, n), dtype),
        jnp.zeros((count, n, n), dtype),
    )


def _two_level_suffix(elems, T, n, dtype, L):
    """Two-level suffix reduction of value elements: parallel suffix scan
    WITHIN chunks of length L + a serial composition across the T/L
    chunk-condensed elements.

    Motivation (f32 accuracy, round-3 VERDICT item 2): the pure
    associative scan materializes conditional-value elements spanning up
    to the whole horizon, and the (I + C J)^-1 factors of long-span
    elements are exactly the ill-conditioned objects that blew up the
    f32 N=500 solve (objective 1692 vs serial 636, docs/PERF.md). Here
    no element ever spans more than L stages: the cross-chunk carry is a
    genuine value function (the terminal element's A=0 collapses the
    conditional form), so each serial step is a condensed Riccati step —
    the numerically forgiving form — while the within-chunk work stays
    parallel. Sequential depth: T/L + log2(L) instead of T (serial) or
    log2(T) (pure associative).
    """
    S = -(-T // L)
    pad = S * L - T
    if pad:
        ids = _identity_elements(pad, n, dtype)
        elems = tuple(
            jnp.concatenate([e, i], axis=0) for e, i in zip(elems, ids)
        )
    chunked = tuple(e.reshape((S, L) + e.shape[1:]) for e in elems)

    # suffix within each chunk (vmapped over chunks): within[s, i]
    # composes stages i..L-1 of chunk s
    within = jax.vmap(
        lambda ce: jax.lax.associative_scan(
            jax.vmap(lambda a, b: _combine_value_elements(b, a)),
            ce, reverse=True,
        )
    )(chunked)
    chunk_elems = tuple(w[:, 0] for w in within)

    # serial suffix across chunks: after[s] = value element composing
    # chunks s+1..S-1 (identity for the last chunk)
    ident = tuple(e[0] for e in _identity_elements(1, n, dtype))

    def step(carry, ce):
        return _combine_value_elements(ce, carry), carry

    _, after = jax.lax.scan(step, ident, chunk_elems, reverse=True)

    # full suffix at (s, i) = within[s, i] composed with after[s]
    full = jax.vmap(
        jax.vmap(_combine_value_elements, in_axes=(0, None))
    )(within, after)
    P = full[4].reshape((S * L, n, n))[:T]
    p = -full[3].reshape((S * L, n))[:T]
    return P, p


def tvlqr_backward_associative(A, B, f, lxx, luu, lux, lx, lu, reg=0.0,
                               chunk=None) -> TVLQRGains:
    """Parallel Riccati backward pass via `lax.associative_scan`.

    Same interface/results as `tvlqr_backward` (to numerical tolerance);
    O(log N) sequential depth, so long horizons parallelize across the
    device's lanes / cores instead of serializing the scan.

    chunk=None runs the pure associative suffix scan (shortest depth,
    f64-recommended at long horizons); chunk=L runs the two-level
    variant (_two_level_suffix) that caps every element's span at L
    stages, trading depth T/L + log2(L) for f32-usable accuracy at long
    horizons (accuracy ladder: tests/test_parallel_riccati.py).

    Requires the input cost blocks luu to be PD on their own (the stage
    elimination inverts luu + reg I, not Quu); AL-augmented problems
    satisfy this. Cholesky failures are flagged per knot like the serial
    pass.
    """
    N, n = A.shape[0], A.shape[1]
    m = B.shape[2]
    dtype = A.dtype
    reg = jnp.asarray(reg, dtype)
    eye_m = jnp.eye(m, dtype=dtype)

    def stage_element(A_k, B_k, f_k, Q_k, R_k, H_k, q_k, r_k):
        R_reg = R_k + reg * eye_m
        # R^-1 [H, r, B^T]
        rhs = jnp.concatenate([H_k, r_k[:, None], B_k.T], axis=1)
        sol, ok = psd_solve_small(R_reg, rhs)
        RiH = sol[:, :n]
        Rir = sol[:, n]
        RiBt = sol[:, n + 1 :]
        A_t = A_k - B_k @ RiH
        b_t = f_k - B_k @ Rir
        C_t = B_k @ RiBt
        J_t = Q_k - H_k.T @ RiH
        eta_t = -(q_k - H_k.T @ Rir)
        return (A_t, b_t, 0.5 * (C_t + C_t.T), eta_t, 0.5 * (J_t + J_t.T)), ok

    elems, ok_all = jax.vmap(stage_element)(
        A, B, f, lxx[:N], luu, lux, lx[:N], lu
    )

    # Append the terminal element (pure cost on x_N)
    zero_A = jnp.zeros((1, n, n), dtype)
    term = (
        zero_A,
        jnp.zeros((1, n), dtype),
        jnp.zeros((1, n, n), dtype),
        -lx[N][None],
        lxx[N][None],
    )
    elems = tuple(jnp.concatenate([e, t], axis=0) for e, t in zip(elems, term))

    if chunk is not None and 0 < int(chunk) < N + 1:
        P, p = _two_level_suffix(elems, N + 1, n, dtype, int(chunk))
    else:
        # NOTE: with reverse=True, associative_scan passes arguments in
        # reversed span order (a = later accumulation, b = earlier
        # element), so swap into our (earlier, later) convention.
        suffix = jax.lax.associative_scan(
            jax.vmap(lambda a, b: _combine_value_elements(b, a)), elems,
            reverse=True,
        )
        P = suffix[4]
        p = -suffix[3]

    # Recover gains per knot from P_{k+1}, p_{k+1} (standard action-value
    # formulas, embarrassingly parallel).
    def gains_at(A_k, B_k, f_k, Q_k, R_k, H_k, q_k, r_k, P_next, p_next):
        BtP = B_k.T @ P_next
        Quu = R_k + BtP @ B_k
        Qux = H_k + BtP @ A_k
        t = P_next @ f_k + p_next
        Qu = r_k + B_k.T @ t
        sol, ok = psd_solve_small(
            Quu + reg * eye_m, jnp.concatenate([Qux, -Qu[:, None]], axis=1)
        )
        K_k = jnp.where(ok, sol[:, :n], 0.0)
        d_k = jnp.where(ok, sol[:, n], 0.0)
        dV_k = jnp.stack([jnp.dot(d_k, Qu), 0.5 * jnp.dot(d_k, Quu @ d_k)])
        return K_k, d_k, dV_k, ok

    K, d, dV_all, ok_gains = jax.vmap(gains_at)(
        A, B, f, lxx[:N], luu, lux, lx[:N], lu, P[1:], p[1:]
    )
    ok_all = jnp.logical_and(ok_all, ok_gains)
    delta_V = jnp.sum(dV_all, axis=0)
    ok = jnp.all(ok_all)
    fail_index = jnp.where(
        ok_all, jnp.asarray(N, jnp.int32), jnp.arange(N, dtype=jnp.int32)
    )
    return TVLQRGains(K, d, P, p, delta_V, ok, jnp.min(fail_index))


def tvlqr_forward_associative(A, B, f, K, d, P, p, x0):
    """Parallel affine closed-loop rollout: the recurrence
    x' = (A - BK) x + (B d + f) is a composition of affine maps,
    prefix-scanned in O(log N) depth. Same results as `tvlqr_forward`.
    """
    N = A.shape[0]
    M = A - jnp.einsum("knm,kmj->knj", B, K)
    v = jnp.einsum("knm,km->kn", B, d) + f

    def compose(a, b):
        # b after a: x -> Mb (Ma x + va) + vb
        Ma, va = a
        Mb, vb = b
        return Mb @ Ma, Mb @ va + vb

    Mp, vp = jax.lax.associative_scan(jax.vmap(compose), (M, v))
    x_rest = jnp.einsum("knj,j->kn", Mp, x0) + vp  # x_1 .. x_N
    x = jnp.concatenate([x0[None], x_rest], axis=0)
    u = jnp.einsum("km->km", d) - jnp.einsum("kmn,kn->km", K, x[:N])
    y = jnp.einsum("knj,kj->kn", P, x) + p
    return x, u, y
