"""Branchless multi-limb modular arithmetic kernels (JAX).

Field elements are (L, *batch) uint32 arrays of 16-bit limbs (limb-major; see
ops.fieldspec). All functions are shape-polymorphic over the batch dims, free
of data-dependent control flow, and safe under jit/vmap/shard_map.

Algorithm notes
  * mont_mul: operand-scanning wide multiply with split lo/hi column
    accumulation (each column bounded < 2^23, comfortably inside uint32),
    followed by word-by-word Montgomery reduction with carries threaded
    through the pivot column only — the classic CIOS dataflow restructured so
    every step is a full-width vector op over the batch axis.
  * carry/borrow ripples are sequential over the (static, small) limb axis
    but fully vectorized over the batch axis, which is where the parallelism
    lives.

This replaces the reference's per-element Rust arkworks field calls
(py_arkworks_bls12381-stubs/__init__.pyi:32-54) with batched device kernels.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import jax.numpy as jnp
from jax import lax

from curdleproofs_jax.ops.fieldspec import LIMB_BITS, LIMB_MASK, FieldSpec

_U32 = jnp.uint32
# Plain Python ints: they inline as jaxpr literals.
_MASK = LIMB_MASK
_SHIFT = LIMB_BITS

# Form of every Montgomery product and carry chain, read at trace time:
#   "loop"  lax loops over the 24-limb axis: the smallest graphs and the
#           fastest compiles; on a GPU every loop step is its own kernel
#           launch, so the CPU's form;
#   "vec"   no loop over limbs at all: limb products as one broadcast
#           multiply, column sums by a shear-and-reduce, Montgomery
#           reduction as two more full products, and every carry/borrow
#           chain resolved by a log-depth lookahead — the GPU's form.
# On the H100 one doubling-free mixed add over 5120 lanes measured
# (compile s / run ms): loop 3.5 / 17.3, vec 14.9 / 1.18; fully unrolled
# limb loops (slice-add or whole-vector column forms) did not compile
# within 120 s and were removed (ROADMAP.md).
LIMB_MODES = ("loop", "vec")
ACCELERATOR_MODE = "vec"
_MODE_OVERRIDE = None


def limb_mode() -> str:
    if _MODE_OVERRIDE is not None:
        return _MODE_OVERRIDE
    from curdleproofs_jax.ops.device import on_accelerator

    return ACCELERATOR_MODE if on_accelerator() else "loop"


@contextlib.contextmanager
def limb_mode_override(mode: str):
    """Trace-time override of the limb form (jitted functions traced under
    another form keep it: clear JAX's caches between forms)."""
    global _MODE_OVERRIDE
    if mode not in LIMB_MODES:
        raise ValueError(f"unknown limb mode {mode!r}")
    prev = _MODE_OVERRIDE
    _MODE_OVERRIDE = mode
    try:
        yield
    finally:
        _MODE_OVERRIDE = prev


def _vec() -> bool:
    return limb_mode() == "vec"


def _const(v) -> jnp.ndarray:
    return jnp.asarray(v, dtype=_U32)


def _mod_vec(spec: FieldSpec, ndim: int):
    """(L, 1, ..) modulus limb vector broadcastable against (L, *B) values."""
    return _const(spec.mod_limbs).reshape(
        (spec.nlimbs,) + (1,) * (ndim - 1)
    )


def _ripple_carry(cols) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Normalize L column accumulators (< 2^32) into 16-bit limbs.
    cols: (L, *B) array or list of (*B,) arrays.
    Returns ((L, *B) limbs, carry-out (*B,))."""
    if isinstance(cols, (list, tuple)):
        cols = jnp.stack(cols)
    if _vec():
        return _normalize_vec(cols, passes=2)

    def body(carry, col):
        v = col + carry
        return v >> _SHIFT, v & _MASK

    carry, limbs = lax.scan(body, jnp.zeros_like(cols[0]), cols)
    return limbs, carry


def _sub_borrow(a, b) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Limbwise a - b with borrow ripple. Returns ((L, *B) diff, borrow (*B,))."""
    base = 1 << LIMB_BITS  # head-room term: v = a + 2^16 - b - borrow >= 0
    if _vec():
        b = jnp.broadcast_to(b, a.shape)
        bin_, bout = _lookahead((a < b).astype(_U32), (a == b).astype(_U32))
        return (a + base - b - bin_) & _MASK, bout

    def body(borrow, ab):
        ai, bi = ab
        v = ai + base - bi - borrow
        return 1 - (v >> _SHIFT), v & _MASK

    bb = jnp.broadcast_to(b, a.shape)
    borrow, diff = lax.scan(body, jnp.zeros_like(a[0]), (a, bb))
    return diff, borrow


def _shift_rows(x, d: int, fill: int):
    """out[k] = x[k - d] along the limb axis, `fill` shifted in at the bottom."""
    pad = jnp.full((d,) + x.shape[1:], fill, x.dtype)
    return jnp.concatenate([pad, x[:-d]], axis=0)


def _lookahead(g, p):
    """Carry (or borrow) lookahead over the limb axis: g, p (K, *B) 0/1
    generate/propagate flags. Log-depth Kogge-Stone prefix of the carry
    monoid. Returns (carry INTO each limb (K, *B), carry out of the top)."""
    d = 1
    while d < g.shape[0]:
        g = g | (p & _shift_rows(g, d, 0))
        p = p & _shift_rows(p, d, 1)
        d *= 2
    return _shift_rows(g, 1, 0), g[-1]


def _normalize_vec(cols, passes: int):
    """Exact carry normalization of (K, *B) column sums without a loop over
    limbs: `passes` carry-save passes bring every column to <= 2^16 (one
    pass suffices for columns <= 2^17, two for columns < 2^32), then one
    lookahead resolves the remaining 0/1 carry chains. Returns
    ((K, *B) 16-bit limbs, carry out of the top limb (*B,))."""
    out = jnp.zeros_like(cols[0])
    for _ in range(passes):
        hi = cols >> _SHIFT
        out = out + hi[-1]
        cols = (cols & _MASK) + _shift_rows(hi, 1, 0)
    cin, cout = _lookahead(cols >> _SHIFT, (cols == _MASK).astype(_U32))
    return (cols + cin) & _MASK, out + cout


def _column_sums(prod):
    """(L, M, *B) 16x16-bit limb products -> (L+M, *B) column sums
    t[k] = sum_{i+j=k} lo[i, j] + sum_{i+j=k-1} hi[i, j], each < 2^22 for
    L, M <= 24. The anti-diagonal sums come from a shear: pad each row with
    L zeros, flatten, drop the last L entries and re-fold with one column
    fewer, which shifts row i right by i; then sum over rows."""
    L, M = prod.shape[:2]
    batch = prod.shape[2:]

    def shear_sum(x):
        x = jnp.concatenate([x, jnp.zeros((L, L) + batch, x.dtype)], axis=1)
        x = x.reshape((L * (M + L),) + batch)[: L * (M + L - 1)]
        return jnp.sum(x.reshape((L, M + L - 1) + batch), axis=0, dtype=_U32)

    lo = shear_sum(prod & _MASK)
    hi = shear_sum(prod >> _SHIFT)
    z = jnp.zeros((1,) + batch, _U32)
    return jnp.concatenate([lo, z]) + jnp.concatenate([z, hi])


def _nprime_limbs(spec: FieldSpec):
    """N' = -p^{-1} mod R as (L,) 16-bit limbs."""
    L = spec.nlimbs
    v = (-pow(spec.modulus, -1, 1 << (16 * L))) % (1 << (16 * L))
    return [(v >> (16 * i)) & _MASK for i in range(L)]


def _mont_mul_vec(spec: FieldSpec, a, b):
    """Montgomery product with no loop over limbs (the "vec" form).

    t = a*b as column sums; m = (t mod R) * N' mod R; u = t + m*p; result
    u / R, reduced once. t's low half and m are only brought to limbs
    <= 2^16 by two carry-save passes (value kept mod R), so every limb
    product stays < 2^32. With m < R(1 + 2^-15) and p < R/8,
    u / R < p^2/R + p(1 + 2^-15) < 2p: one conditional subtraction."""
    L = spec.nlimbs
    batch = a.shape[1:]
    ones = (1,) * len(batch)

    def partial(c):  # carry-save passes, carries out of the top dropped
        for _ in range(2):
            c = (c & _MASK) + _shift_rows(c >> _SHIFT, 1, 0)
        return c

    t = _column_sums(a[:, None] * b[None, :])  # (2L, *B)
    tl = partial(t[:L])
    npr = _const(_nprime_limbs(spec)).reshape((1, L) + ones)
    m = partial(_column_sums(tl[:, None] * npr)[:L])
    modr = _const(spec.mod_limbs).reshape((1, L) + ones)
    u = t + _column_sums(m[:, None] * modr)
    limbs, _ = _normalize_vec(u, passes=2)  # low half is all zero
    res = limbs[L:]
    d, brw = _sub_borrow(res, jnp.broadcast_to(_mod_vec(spec, a.ndim), res.shape))
    return jnp.where(brw == 0, d, res)


def add(spec: FieldSpec, a, b):
    """(a + b) mod p, canonical in/out."""
    mod = _mod_vec(spec, a.ndim)
    s, c = _ripple_carry(list(a + b))
    d, brw = _sub_borrow(s, mod)
    use_d = (c == 1) | (brw == 0)
    return jnp.where(use_d, d, s)


def sub(spec: FieldSpec, a, b):
    """(a - b) mod p, canonical in/out."""
    mod = _mod_vec(spec, a.ndim)
    d, brw = _sub_borrow(a, b)
    d2, _ = _ripple_carry(list(d + mod))
    return jnp.where(brw == 1, d2, d)


def neg(spec: FieldSpec, a):
    """(-a) mod p."""
    return sub(spec, jnp.zeros_like(a), a)


def double(spec: FieldSpec, a):
    return add(spec, a, a)


def is_zero(spec: FieldSpec, a):
    """Boolean mask (*B,): a == 0 (canonical representation assumed)."""
    return jnp.all(a == 0, axis=0)


def eq(spec: FieldSpec, a, b):
    return jnp.all(a == b, axis=0)


def select(mask, a, b):
    """Elementwise field select: mask (*B,) -> a where True else b."""
    return jnp.where(mask[None, ...], a, b)


def mont_mul(spec: FieldSpec, a, b):
    """Montgomery product: a * b * R^{-1} mod p, canonical in/out.

    a, b: (L, *B) uint32 16-bit limbs in Montgomery form (or any canonical
    residues — the function is just a modmul up to the R^{-1} factor).
    Column accumulators stay < 2^23 (L<=24 lo+hi 16-bit terms per column plus
    pivot carries), well inside uint32.
    """
    if _vec():
        return _mont_mul_vec(spec, a, b)
    return _mont_mul_looped(spec, a, b)


def _mont_mul_looped(spec: FieldSpec, a, b):
    """Operand-scanning wide product, then word-by-word Montgomery
    reduction, with both limb loops as lax.fori_loop (the "loop" form)."""
    L = spec.nlimbs
    n0inv = spec.n0inv  # python int -> jaxpr literal
    batch_shape = a.shape[1:]
    modv = _mod_vec(spec, a.ndim)
    bb = jnp.broadcast_to(b, a.shape)
    zrow = jnp.zeros((1,) + batch_shape, dtype=_U32)
    modb = jnp.broadcast_to(modv, a.shape)

    def wide_body(i, t):
        ai = lax.dynamic_index_in_dim(a, i, axis=0, keepdims=True)  # (1, *B)
        p = ai * bb
        w = lax.dynamic_slice_in_dim(t, i, L + 1, axis=0)
        w = w + jnp.concatenate([p & _MASK, zrow], 0)
        w = w + jnp.concatenate([zrow, p >> _SHIFT], 0)
        return lax.dynamic_update_slice_in_dim(t, w, i, axis=0)

    t = jnp.zeros((2 * L + 1,) + batch_shape, dtype=_U32)
    t = lax.fori_loop(0, L, wide_body, t)

    def red_body(i, t):
        w = lax.dynamic_slice_in_dim(t, i, L + 1, axis=0)
        m = (w[0] * n0inv) & _MASK
        p = m[None, ...] * modb
        w = w + jnp.concatenate([p & _MASK, zrow], 0)
        w = w + jnp.concatenate([zrow, p >> _SHIFT], 0)
        w = w.at[1].add(w[0] >> _SHIFT)
        return lax.dynamic_update_slice_in_dim(t, w, i, axis=0)

    t = lax.fori_loop(0, L, red_body, t)
    return _mont_finish(t, L, modv)


def _mont_finish(t, L, modv):
    """Normalize the surviving upper half of the accumulator and reduce to
    [0, p). t[2L] + ripple carry < 2 by the Montgomery bound (t/R < 2p)."""
    res, carry = _ripple_carry(t[L : 2 * L])
    top = t[2 * L] + carry
    d, brw = _sub_borrow(res, modv)
    use_d = (top > 0) | (brw == 0)
    return jnp.where(use_d, d, res)


def mont_sqr(spec: FieldSpec, a):
    return mont_mul(spec, a, a)


def to_mont(spec: FieldSpec, a):
    """Canonical residue -> Montgomery form (multiply by R^2)."""
    r2 = _const(spec.r2_limbs).reshape((spec.nlimbs,) + (1,) * (a.ndim - 1))
    return mont_mul(spec, a, jnp.broadcast_to(r2, a.shape))

def from_mont(spec: FieldSpec, a):
    """Montgomery form -> canonical residue (multiply by 1)."""
    one = jnp.zeros_like(a).at[0].set(1)
    return mont_mul(spec, a, one)


def mont_pow_const(spec: FieldSpec, a, e: int):
    """a^e (Montgomery in/out) for a static exponent, via an MSB-first
    square-and-multiply lax.scan (graph stays O(1) montmuls)."""
    if e == 0:
        one = _const(spec.one_mont).reshape((spec.nlimbs,) + (1,) * (a.ndim - 1))
        return jnp.broadcast_to(one, a.shape)
    bits = [(e >> i) & 1 for i in range(e.bit_length())][::-1]  # MSB first
    bits_arr = jnp.asarray(bits, dtype=jnp.uint32)

    def body(acc, bit):
        acc = mont_sqr(spec, acc)
        acc_mul = mont_mul(spec, acc, a)
        acc = jnp.where(bit > 0, acc_mul, acc)
        return acc, None

    # first bit is always 1: start from a
    acc, _ = lax.scan(body, a, bits_arr[1:])
    return acc


def mont_inv(spec: FieldSpec, a):
    """Batched modular inverse via Fermat (a^(p-2)); 0 -> 0.
    Montgomery in/out."""
    return mont_pow_const(spec, a, spec.modulus - 2)
