"""Work-efficient batched group-reductions and prefix scans over point vectors.

The MSM engine (ops.msm) needs two collective primitives over Jacobian point
vectors, both built purely from complete group adds:

  * tree_reduce_hybrid: sum N points -> 1
  * inclusive_scan:     P_j = p_0 + ... + p_j for all j (Blelloch-style, ~2N
                        adds total)

Graph-size strategy: a group add is a large subgraph, and every copy of it
in a program costs compile time, so levels are unrolled only while the
vector is wider than SMALL_WIDTH; below that a fixed-shape Hillis-Steele
loop (lax.fori_loop with ONE add in the body) does the job at O(N log N)
work. On the GPU a copy costs about a second of compile per field
multiplication while a full-width step costs about the same as a halved one
(kernel launches, not lanes, set the time), so SMALL_WIDTH is above every
width the stream engine reduces and each of its reductions compiles exactly
one add.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from curdleproofs_jax.ops.g1 import JPoints, jadd, jinf, jselect

SMALL_WIDTH = 1 << 20


def _roll(p: JPoints, shift) -> JPoints:
    return JPoints(
        jnp.roll(p.x, shift, axis=-1),
        jnp.roll(p.y, shift, axis=-1),
        jnp.roll(p.z, shift, axis=-1),
    )


def _interleave(a: JPoints, b: JPoints) -> JPoints:
    """[a0, b0, a1, b1, ...] along the last axis."""

    def go(x, y):
        stacked = jnp.stack([x, y], axis=-1)
        return stacked.reshape(x.shape[:-1] + (2 * x.shape[-1],))

    return JPoints(go(a.x, b.x), go(a.y, b.y), go(a.z, b.z))


def _split_even_odd(p: JPoints):
    ev = JPoints(p.x[..., 0::2], p.y[..., 0::2], p.z[..., 0::2])
    od = JPoints(p.x[..., 1::2], p.y[..., 1::2], p.z[..., 1::2])
    return ev, od


def _shift_in_inf(p: JPoints) -> JPoints:
    """Shift right by one along the last axis, shifting in infinity."""
    batch = p.x.shape[1:-1]
    pad = jinf(batch + (1,))
    return JPoints(
        jnp.concatenate([pad.x, p.x[..., :-1]], axis=-1),
        jnp.concatenate([pad.y, p.y[..., :-1]], axis=-1),
        jnp.concatenate([pad.z, p.z[..., :-1]], axis=-1),
    )


def _hs_scan(p: JPoints) -> JPoints:
    """Hillis-Steele inclusive scan at fixed width (for the small phase)."""
    n = p.x.shape[-1]
    steps = max(1, (n - 1).bit_length())
    idx = jnp.arange(n)

    def body(s, p):
        d = jnp.int32(1) << s
        rolled = _roll(p, d)
        rolled = jselect(idx >= d, rolled, jinf(p.x.shape[1:]))
        return jadd(p, rolled)

    return lax.fori_loop(0, steps, body, p)


def _hs_reduce(p: JPoints) -> JPoints:
    """Reduce fixed-width vector to lane 0 via log-step shifted adds."""
    n = p.x.shape[-1]
    steps = (n - 1).bit_length()
    idx = jnp.arange(n)

    def body(s, p):
        d = jnp.int32(n) >> (s + 1)
        rolled = _roll(p, -d)
        rolled = jselect(idx < jnp.int32(n) - d, rolled, jinf(p.x.shape[1:]))
        return jadd(p, rolled)

    p = lax.fori_loop(0, steps, body, p)
    return JPoints(p.x[..., 0], p.y[..., 0], p.z[..., 0])


def pad_pow2(p: JPoints, min_width: int = 1) -> JPoints:
    """Pad the last axis with infinity up to the next power of two."""
    n = p.x.shape[-1]
    m = max(min_width, 1)
    while m < n:
        m *= 2
    if m == n:
        return p
    pad = jinf(p.x.shape[1:-1] + (m - n,))
    return JPoints(
        jnp.concatenate([p.x, pad.x], axis=-1),
        jnp.concatenate([p.y, pad.y], axis=-1),
        jnp.concatenate([p.z, pad.z], axis=-1),
    )


def tree_reduce_hybrid(p: JPoints) -> JPoints:
    """Sum all lanes of the last axis (any width; padded internally)."""
    p = pad_pow2(p)
    n = p.x.shape[-1]
    if n == 1:
        return JPoints(p.x[..., 0], p.y[..., 0], p.z[..., 0])
    while n > SMALL_WIDTH:
        n //= 2
        lo = JPoints(p.x[..., :n], p.y[..., :n], p.z[..., :n])
        hi = JPoints(p.x[..., n:], p.y[..., n:], p.z[..., n:])
        p = jadd(lo, hi)
    return _hs_reduce(p)


def inclusive_scan(p: JPoints) -> JPoints:
    """Inclusive group-prefix-scan along the last axis (width = power of 2)."""
    n = p.x.shape[-1]
    if n & (n - 1):
        raise ValueError("inclusive_scan requires power-of-two width")
    if n <= SMALL_WIDTH:
        return _hs_scan(p)
    ev, od = _split_even_odd(p)
    pairs = jadd(ev, od)  # width n/2: sums of adjacent pairs
    sp = inclusive_scan(pairs)  # prefixes at odd positions
    evens = jadd(_shift_in_inf(sp), ev)  # prefixes at even positions
    return _interleave(evens, sp)
