"""Sequence-parallel Riccati: block-partition the horizon across devices.

The multi-device long-horizon option (SURVEY §5 "long-context"): the
value-function elements of the parallel Riccati construction
(altro_tpu.tvlqr) are sharded over a 'horizon' mesh axis; each device
suffix-scans its block locally, block aggregates are exchanged with one
`all_gather` (5 small matrices per device), and the tail
composition is applied locally — the classic distributed-scan
decomposition, O(N/D + log D) depth on D devices.

Gains are then recovered locally (the only cross-block datum a knot needs
is its block's combined tail). Results match the single-device passes to
numerical tolerance.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from altro_tpu.ops.smallmat import mm, mtm, mtv, mv, psd_solve_small
from altro_tpu.tvlqr import TVLQRGains, _combine_value_elements

__all__ = [
    "tvlqr_backward_horizon_sharded",
    "tvlqr_backward_batch_horizon_sharded",
]

# _PRECISION_NOTE: the block compositions chain (I + C J)^-1 products of
# dense small matrices, and their f32 error compounds over the horizon. A
# GPU may run an f32 product at DEFAULT precision in TF32 (10-bit
# mantissa), so the sharded passes trace their products at "highest".


def _identity_element(n, dtype):
    eye = jnp.eye(n, dtype=dtype)
    z = jnp.zeros((n,), dtype)
    zm = jnp.zeros((n, n), dtype)
    return (eye, z, zm, z, zm)


def _make_local_block(n, dtype, axis, reg, eye_m):
    """Per-device block of the distributed-scan Riccati backward pass.

    Returns local_block(A_b, B_b, f_b, lxx_b, luu_b, lux_b, lx_b, lu_b,
    term_b) operating on this device's horizon slice; collectives
    (all_gather of block totals, psum of dV, pmin of ok) ride `axis`.
    Safe under an outer vmap over batch lanes (the collectives only name
    the horizon axis), which is how the 2-D batch x horizon variant
    batches it.
    """

    def local_block(A_b, B_b, f_b, lxx_b, luu_b, lux_b, lx_b, lu_b, term_b):
        my = jax.lax.axis_index(axis)

        def stage_element(A_k, B_k, f_k, Q_k, R_k, H_k, q_k, r_k, term_k):
            R_reg = R_k + reg * eye_m
            rhs = jnp.concatenate([H_k, r_k[:, None], B_k.T], axis=1)
            sol, ok = psd_solve_small(R_reg, rhs)
            RiH = sol[:, :n]
            Rir = sol[:, n]
            RiBt = sol[:, n + 1 :]
            A_t = A_k - B_k @ RiH
            b_t = f_k - mv(B_k, Rir)
            C_t = B_k @ RiBt
            J_t = Q_k - mtm(H_k, RiH)
            eta_t = -(q_k - mtv(RiH, r_k))
            elem = (A_t, b_t, 0.5 * (C_t + C_t.T), eta_t, 0.5 * (J_t + J_t.T))
            # Terminal slot: pure cost element (A=0, b=0, C=0)
            zm = jnp.zeros((n, n), dtype)
            z = jnp.zeros((n,), dtype)
            term_elem = (zm, z, zm, -q_k, Q_k)
            sel = lambda a, b: jnp.where(term_k, a, b)
            return jax.tree.map(sel, term_elem, elem), jnp.logical_or(ok, term_k)

        elems, ok_elems = jax.vmap(stage_element)(
            A_b, B_b, f_b, lxx_b, luu_b, lux_b, lx_b, lu_b, term_b
        )

        # Local suffix scan (reverse composition; see tvlqr.py note on
        # associative_scan's reversed argument order)
        suffix = jax.lax.associative_scan(
            jax.vmap(lambda a, b: _combine_value_elements(b, a)), elems, reverse=True
        )
        block_total = jax.tree.map(lambda s: s[0], suffix)

        # Exchange block totals; tail_d = totals_{d+1} o ... o totals_{D-1}.
        # Computed as a MASKED compose (devices <= my replaced by the
        # identity element, then one log-depth reduce) rather than a
        # suffix scan indexed at (my + 1): a device-varying dynamic
        # slice of the replicated tails triggered a jit(shard_map)
        # miscompile on the virtual-device CPU backend (wrong P at every
        # odd knot; structure-sensitive), while the masked form is
        # correct eager and jitted.
        totals = jax.lax.all_gather(block_total, axis)  # [D, ...]
        D = totals[0].shape[0]
        ident = _identity_element(n, dtype)
        ident_b = jax.tree.map(
            lambda i: jnp.broadcast_to(i, (D,) + i.shape), ident
        )
        keep = jnp.arange(D) > my
        masked = jax.tree.map(
            lambda t, i: jnp.where(keep.reshape((D,) + (1,) * (t.ndim - 1)), t, i),
            totals, ident_b,
        )
        my_tail = jax.tree.map(
            lambda s: s[0],
            jax.lax.associative_scan(
                jax.vmap(lambda a, b: _combine_value_elements(b, a)),
                masked, reverse=True,
            ),
        )

        # Apply the tail to every local suffix
        full = jax.vmap(lambda e: _combine_value_elements(e, my_tail))(suffix)
        P_loc = full[4]
        p_loc = -full[3]

        # P_{k+1} for the local gains: shift by one, last row takes the tail
        P_next = jnp.concatenate([P_loc[1:], my_tail[4][None]], axis=0)
        p_next = jnp.concatenate([p_loc[1:], -my_tail[3][None]], axis=0)

        def gains_at(A_k, B_k, f_k, Q_k, R_k, H_k, q_k, r_k, Pn, pn, term_k):
            BtP = mtm(B_k, Pn)
            Quu = R_k + mm(BtP, B_k)
            Qux = H_k + mm(BtP, A_k)
            t = mv(Pn, f_k) + pn
            Qu = r_k + mtv(B_k, t)
            sol, ok = psd_solve_small(
                Quu + reg * eye_m, jnp.concatenate([Qux, -Qu[:, None]], axis=1)
            )
            valid = jnp.logical_and(ok, jnp.logical_not(term_k))
            K_k = jnp.where(valid, sol[:, :n], 0.0)
            d_k = jnp.where(valid, sol[:, n], 0.0)
            dV_k = jnp.where(
                valid,
                jnp.stack([jnp.dot(d_k, Qu), 0.5 * jnp.dot(d_k, mv(Quu, d_k))]),
                0.0,
            )
            return K_k, d_k, dV_k, jnp.logical_or(ok, term_k)

        K_loc, d_loc, dV_loc, ok_gains = jax.vmap(gains_at)(
            A_b, B_b, f_b, lxx_b, luu_b, lux_b, lx_b, lu_b, P_next, p_next, term_b
        )
        ok_loc = jnp.logical_and(ok_elems, ok_gains)
        dV_partial = jnp.sum(dV_loc, axis=0)
        dV_total = jax.lax.psum(dV_partial, axis)
        ok_all = jax.lax.pmin(jnp.min(ok_loc.astype(jnp.int32)), axis)
        return K_loc, d_loc, P_loc, p_loc, dV_total, ok_all, ok_loc

    return local_block


def tvlqr_backward_horizon_sharded(
    A, B, f, lxx, luu, lux, lx, lu, mesh: Mesh, axis: str = "horizon", reg=0.0
) -> TVLQRGains:
    """Distributed parallel Riccati backward pass.

    Same interface/results as `tvlqr_backward(_associative)`; requires
    (N + 1) divisible by the mesh axis size. luu must be PD on its own
    (same condition as the associative variant).
    """
    N, n = A.shape[0], A.shape[1]
    m = B.shape[2]
    dtype = A.dtype
    D = mesh.shape[axis]
    if (N + 1) % D != 0:
        raise ValueError(f"(N+1)={N + 1} must be divisible by mesh axis size {D}")
    reg = jnp.asarray(reg, dtype)
    eye_m = jnp.eye(m, dtype=dtype)

    # Pad stage arrays to N+1 rows so one axis shards uniformly; row N is
    # the terminal slot (identity luu keeps the padded solve well-posed).
    pad = lambda a: jnp.concatenate([a, jnp.zeros_like(a[:1])], axis=0)
    A_p = pad(A)
    B_p = pad(B)
    f_p = pad(f)
    luu_p = jnp.concatenate([luu, eye_m[None]], axis=0)
    lux_p = pad(lux)
    lu_p = pad(lu)
    is_term = jnp.arange(N + 1) == N

    spec = P(axis)
    local_block = _make_local_block(n, dtype, axis, reg, eye_m)

    # jit the mapped computation: eager shard_map dispatches through a
    # drastically slower path (measured 35 s vs 3.7 s for this program on
    # the 8-virtual-device CPU mesh); under an enclosing jit this is a
    # no-op
    mapped = jax.jit(jax.shard_map(
        local_block,
        mesh=mesh,
        in_specs=(spec,) * 9,
        out_specs=(spec, spec, spec, spec, P(), P(), spec),
        check_vma=False,
    ))
    with jax.default_matmul_precision("highest"):  # see _PRECISION_NOTE
        K_f, d_f, P_full, p_full, dV, ok_all, ok_rows = mapped(
            A_p, B_p, f_p, lxx, luu_p, lux_p, lx, lu_p, is_term
        )
    K = K_f[:N]
    d = d_f[:N]
    ok = ok_all.astype(bool)
    fail_index = jnp.where(
        ok_rows[:N], jnp.asarray(N, jnp.int32), jnp.arange(N, dtype=jnp.int32)
    )
    return TVLQRGains(K, d, P_full, p_full, dV, ok, jnp.min(fail_index))


def tvlqr_backward_batch_horizon_sharded(
    A, B, f, lxx, luu, lux, lx, lu, mesh: Mesh,
    batch_axis: str = "batch", axis: str = "horizon", reg=0.0,
) -> TVLQRGains:
    """2-D-sharded batched Riccati backward pass: independent problem
    lanes over the mesh's `batch_axis`, each lane's horizon
    block-partitioned over `axis` (lanes ride one mesh axis, the
    distributed-scan exchanges ride the other).

    Args are the batched stacks (A: [Bsz, N, n, n], ..., lx: [Bsz, N+1, n]);
    the batch mesh axis size must divide Bsz, the horizon axis size must
    divide (N + 1). Returns batched TVLQRGains matching
    `jax.vmap(tvlqr_backward)`.
    """
    N, n = A.shape[1], A.shape[2]
    m = B.shape[3]
    dtype = A.dtype
    D = mesh.shape[axis]
    Db = mesh.shape[batch_axis]
    if (N + 1) % D != 0:
        raise ValueError(f"(N+1)={N + 1} must be divisible by mesh axis size {D}")
    if A.shape[0] % Db != 0:
        raise ValueError(
            f"batch {A.shape[0]} must be divisible by mesh axis size {Db}"
        )
    reg_arr = jnp.asarray(reg, dtype)
    eye_m = jnp.eye(m, dtype=dtype)

    pad = lambda a: jnp.concatenate([a, jnp.zeros_like(a[:, :1])], axis=1)
    A_p, B_p, f_p, lux_p, lu_p = pad(A), pad(B), pad(f), pad(lux), pad(lu)
    luu_p = jnp.concatenate(
        [luu, jnp.broadcast_to(eye_m, (luu.shape[0], 1, m, m))], axis=1
    )
    is_term = jnp.arange(N + 1) == N

    block = _make_local_block(n, dtype, axis, reg_arr, eye_m)

    def batched_block(A_b, B_b, f_b, lxx_b, luu_b, lux_b, lx_b, lu_b, term_b):
        return jax.vmap(
            lambda *args: block(*args, term_b)
        )(A_b, B_b, f_b, lxx_b, luu_b, lux_b, lx_b, lu_b)

    bh = P(batch_axis, axis)
    # see note above: jit to avoid the eager shard_map dispatch path
    mapped = jax.jit(jax.shard_map(
        batched_block,
        mesh=mesh,
        in_specs=(bh,) * 8 + (P(axis),),
        out_specs=(bh, bh, bh, bh, P(batch_axis), P(batch_axis), bh),
        check_vma=False,
    ))
    with jax.default_matmul_precision("highest"):  # see _PRECISION_NOTE
        K_f, d_f, P_full, p_full, dV, ok_all, ok_rows = mapped(
            A_p, B_p, f_p, lxx, luu_p, lux_p, lx, lu_p, is_term
        )
    K = K_f[:, :N]
    d = d_f[:, :N]
    ok = ok_all.astype(bool)
    idx = jnp.arange(N, dtype=jnp.int32)[None, :]
    fail_index = jnp.where(ok_rows[:, :N], jnp.asarray(N, jnp.int32), idx)
    return TVLQRGains(K, d, P_full, p_full, dV, ok, jnp.min(fail_index, axis=1))
