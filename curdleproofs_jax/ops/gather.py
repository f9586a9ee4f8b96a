"""Exact u32 gathers for the MSM engines (XLA `take_along_axis`).

The host-sorted Pippenger paths (ops.msm) gather point records into
digit-sorted order and pick bucket-boundary prefixes out of scan outputs.
Indices outside [0, N) gather 0, so an all-zero Jacobian triple (z == 0,
the identity) needs no masking downstream.
"""
from __future__ import annotations

import jax.numpy as jnp


def gather_u32(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """table (R, W, N), idx (W, M) int -> (R, W, M) with
    out[r, w, j] = table[r, w, idx[w, j]] (0 where idx is out of range)."""
    N = table.shape[-1]
    hit = (idx >= 0) & (idx < N)
    g = jnp.take_along_axis(table, jnp.clip(idx, 0, N - 1)[None], axis=-1)
    return jnp.where(hit[None], g, jnp.zeros_like(g))


def gather_u32_shared(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """One table shared by every window: table (R, N), idx (W, M) ->
    (R, W, M), out[r, w, j] = table[r, idx[w, j]] (0 out of range)."""
    N = table.shape[-1]
    hit = (idx >= 0) & (idx < N)
    g = jnp.take(table, jnp.clip(idx, 0, N - 1), axis=-1)
    return jnp.where(hit[None], g, jnp.zeros_like(g))
