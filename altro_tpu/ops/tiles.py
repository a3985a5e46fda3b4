"""Lane-tile layout of the batched solve.

Batched arrays live as `[Bt, orig..., 8, 128]`: the batch is cut into
tiles of 1024 lanes, and each tile's lanes are the two TRAILING axes.
Per-lane code is lifted onto this layout with trailing-axis vmaps
(ops/tile_iter.tile_vmap), so XLA keeps the lane axis minor and every
per-knot operand row is lane-contiguous — which is also what the GPU
kernels load (ops/pallas_riccati.py, ops/pallas_rollout_tiled.py).

The 1024-lane tile size is inherited from the system's first target and
has not been re-chosen for the GPU (ROADMAP.md).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["SUB", "LANE", "BATCH_TILE", "batch_to_tiles", "tiles_to_batch"]

SUB, LANE = 8, 128
BATCH_TILE = SUB * LANE  # 1024 lanes per batch tile


def batch_to_tiles(x):
    """[B, *rest] -> [Bt, *rest, 8, 128] (an explicit relayout; only for
    pipeline edges — producers inside the solve emit tiles directly)."""
    rest = x.shape[1:]
    bt = x.shape[0] // BATCH_TILE
    x = x.reshape((bt, SUB, LANE) + rest)
    perm = (0,) + tuple(range(3, 3 + len(rest))) + (1, 2)
    return jnp.transpose(x, perm)


def tiles_to_batch(x):
    """[Bt, *rest, 8, 128] -> [B, *rest] (explicit relayout)."""
    nd = x.ndim
    perm = (0, nd - 2, nd - 1) + tuple(range(1, nd - 2))
    return jnp.transpose(x, perm).reshape(
        (x.shape[0] * BATCH_TILE,) + x.shape[1:-2]
    )
