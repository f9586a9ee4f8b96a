"""Batched BLS12-381 G1 group kernels (JAX).

Points are structs-of-arrays of Fq limbs (limb-major (24, *B) uint32,
Montgomery form):

  * `JPoints` — Jacobian (X, Y, Z), Z == 0 encodes infinity.
  * `APoints` — affine (x, y) plus an explicit infinity mask.

All group ops are *complete* and branchless: doubling, inverse and infinity
inputs are resolved with masked selects, never data-dependent branches, so
everything jits to static device programs. Replaces the reference's per-point
Rust calls (py_arkworks_bls12381-stubs/__init__.pyi:5-30) with vectorized
device kernels; formulas are the standard EFD Jacobian a=0 formulas
(dbl-2009-l, add-2007-bl, madd-2007-bl).

BLS12-381 G1 has prime order (no 2-torsion), so y == 0 never occurs for
finite curve points and the doubling formula needs no special case.
"""
from __future__ import annotations

from functools import partial
from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from curdleproofs_jax.curve import G1
from curdleproofs_jax.fields import Fr
from curdleproofs_jax.ops import modarith as ma
from curdleproofs_jax.ops.fieldspec import (
    FQ_SPEC,
    FR_SPEC,
    ints_to_limbs,
    limbs_to_ints,
)

_add = partial(ma.add, FQ_SPEC)
_sub = partial(ma.sub, FQ_SPEC)
_mul = partial(ma.mont_mul, FQ_SPEC)
_sqr = partial(ma.mont_sqr, FQ_SPEC)
_neg = partial(ma.neg, FQ_SPEC)
_dbl = partial(ma.double, FQ_SPEC)
_is0 = partial(ma.is_zero, FQ_SPEC)
_feq = partial(ma.eq, FQ_SPEC)
_fsel = ma.select

FQ_LIMBS = FQ_SPEC.nlimbs
FR_LIMBS = FR_SPEC.nlimbs


class JPoints(NamedTuple):
    x: jnp.ndarray  # (24, *B) Montgomery
    y: jnp.ndarray
    z: jnp.ndarray  # z == 0 <=> infinity


class APoints(NamedTuple):
    x: jnp.ndarray  # (24, *B) Montgomery
    y: jnp.ndarray
    inf: jnp.ndarray  # (*B,) bool


def jselect(mask, p: JPoints, q: JPoints) -> JPoints:
    """Per-lane select: p where mask else q."""
    return JPoints(_fsel(mask, p.x, q.x), _fsel(mask, p.y, q.y), _fsel(mask, p.z, q.z))


def jinf(batch_shape=()) -> JPoints:
    z = jnp.zeros((FQ_LIMBS,) + tuple(batch_shape), dtype=jnp.uint32)
    one = jnp.zeros_like(z).at[0].set(1)
    return JPoints(one, one, z)


def is_inf(p: JPoints):
    return _is0(p.z)


def lift(a: APoints) -> JPoints:
    """Affine -> Jacobian (z = 1 in Montgomery form, masked by inf)."""
    one = ma._const(FQ_SPEC.one_mont).reshape(
        (FQ_LIMBS,) + (1,) * (a.x.ndim - 1)
    )
    z = jnp.where(a.inf[None], jnp.zeros_like(a.x), jnp.broadcast_to(one, a.x.shape))
    return JPoints(a.x, a.y, z)


def jdbl(p: JPoints) -> JPoints:
    """Jacobian doubling, complete (infinity passes through via z=0)."""
    a = _sqr(p.x)
    b = _sqr(p.y)
    c = _sqr(b)
    t = _add(p.x, b)
    d = _dbl(_sub(_sub(_sqr(t), a), c))
    e = _add(_add(a, a), a)
    f = _sqr(e)
    x3 = _sub(f, _dbl(d))
    c8 = _dbl(_dbl(_dbl(c)))
    y3 = _sub(_mul(e, _sub(d, x3)), c8)
    z3 = _dbl(_mul(p.y, p.z))
    return JPoints(x3, y3, z3)


def jadd(
    p: JPoints, q: JPoints, handle_doubling: bool = True
) -> JPoints:
    """Complete Jacobian + Jacobian addition.

    handle_doubling=False drops the p == q branch (saves a fused doubling).
    ONLY sound where that case is impossible — e.g. the windowed ladder's
    table adds: acc = 8*prefix*P vs table d*P with d in [1,7] and k < r gives
    8*prefix ≡ d (mod r) no solutions (d/8 non-integral; (r+d)/8 integral only
    for d=7 needing a 252-bit prefix equal to (r+7)/8, i.e. k >= r; (2r+d)/8
    needs 253 bits > max prefix width). Cancellation (p == -q) stays handled
    for free via z3 = 0.
    """
    z1z1 = _sqr(p.z)
    z2z2 = _sqr(q.z)
    u1 = _mul(p.x, z2z2)
    u2 = _mul(q.x, z1z1)
    s1 = _mul(_mul(p.y, q.z), z2z2)
    s2 = _mul(_mul(q.y, p.z), z1z1)
    h = _sub(u2, u1)
    i = _sqr(_dbl(h))
    j = _mul(h, i)
    r = _dbl(_sub(s2, s1))
    v = _mul(u1, i)
    x3 = _sub(_sub(_sqr(r), j), _dbl(v))
    y3 = _sub(_mul(r, _sub(v, x3)), _dbl(_mul(s1, j)))
    zz = _sub(_sub(_sqr(_add(p.z, q.z)), z1z1), z2z2)
    z3 = _mul(zz, h)  # h == 0 -> z3 == 0: P + (-P) lands on infinity for free
    res = JPoints(x3, y3, z3)

    if handle_doubling:
        dbl_case = _is0(h) & _is0(r) & ~is_inf(p) & ~is_inf(q)
        res = jselect(dbl_case, jdbl(p), res)
    res = jselect(is_inf(q), p, res)
    res = jselect(is_inf(p), q, res)
    return res


def jmadd(
    p: JPoints, q: APoints, handle_doubling: bool = True
) -> JPoints:
    """Complete Jacobian + affine mixed addition (madd-2007-bl).

    handle_doubling=False is sound only where p == q (as points) is
    impossible — e.g. odd-multiple table construction 2kP + P (equality would
    force (2k-1)P = inf, i.e. P = inf, which the infinity selects handle)."""
    z1z1 = _sqr(p.z)
    u2 = _mul(q.x, z1z1)
    s2 = _mul(_mul(q.y, p.z), z1z1)
    h = _sub(u2, p.x)
    hh = _sqr(h)
    i = _dbl(_dbl(hh))
    j = _mul(h, i)
    r = _dbl(_sub(s2, p.y))
    v = _mul(p.x, i)
    x3 = _sub(_sub(_sqr(r), j), _dbl(v))
    y3 = _sub(_mul(r, _sub(v, x3)), _dbl(_mul(p.y, j)))
    z3 = _mul(_dbl(p.z), h)  # h == 0 -> infinity for free
    res = JPoints(x3, y3, z3)

    if handle_doubling:
        dbl_case = _is0(h) & _is0(r) & ~is_inf(p) & ~q.inf
        res = jselect(dbl_case, jdbl(p), res)
    res = jselect(q.inf, p, res)
    res = jselect(is_inf(p), lift(q), res)
    return res


def jmadd_flagged(p: JPoints, q: APoints):
    """Mixed add WITHOUT the fused doubling path, plus a per-lane flag.

    The complete madd (handle_doubling=True) spends ~5.5 extra montmul-
    equivalents per step on a full Jacobian doubling that exists only for
    the p == q edge case — astronomically rare in MSM prefix scans (it
    requires a running prefix to exactly equal the incoming base point).
    This variant skips it and instead returns (res, dbl_mask): res is WRONG
    (z3 == 0) exactly where dbl_mask is set, and the caller must detect the
    mask and redo the affected work on a complete path (ops.msm falls back
    to the doubling-safe full-prefix pipeline). Cancellation p == -q and
    both infinity cases remain exact here. The flag reads h and r straight
    off the formula's intermediates — zero extra field muls."""
    z1z1 = _sqr(p.z)
    u2 = _mul(q.x, z1z1)
    s2 = _mul(_mul(q.y, p.z), z1z1)
    h = _sub(u2, p.x)
    hh = _sqr(h)
    i = _dbl(_dbl(hh))
    j = _mul(h, i)
    r = _dbl(_sub(s2, p.y))
    v = _mul(p.x, i)
    x3 = _sub(_sub(_sqr(r), j), _dbl(v))
    y3 = _sub(_mul(r, _sub(v, x3)), _dbl(_mul(p.y, j)))
    z3 = _mul(_dbl(p.z), h)
    res = JPoints(x3, y3, z3)
    dbl = _is0(h) & _is0(r) & ~is_inf(p) & ~q.inf
    res = jselect(q.inf, p, res)
    res = jselect(is_inf(p), lift(q), res)
    return res, dbl


def jneg(p: JPoints) -> JPoints:
    return JPoints(p.x, _neg(p.y), p.z)


def to_affine(p: JPoints) -> APoints:
    """Jacobian -> affine via batched Fermat inversion of Z."""
    zinv = ma.mont_inv(FQ_SPEC, p.z)
    zinv2 = _sqr(zinv)
    x = _mul(p.x, zinv2)
    y = _mul(p.y, _mul(zinv, zinv2))
    return APoints(x, y, is_inf(p))


# ---------------------------------------------------------------------------
# scalar multiplication / reduction
# ---------------------------------------------------------------------------


def scalar_mul_glv(points: APoints, s1, neg1, s2) -> JPoints:
    """Per-lane k_i * P_i by the GLV/Straus dual-table ladder:
    k*P = k1*P + k2*phi(P) with |k1| < 2^129 signed, 0 <= k2 <= lambda
    (ops.glv.decompose) and phi(X, Y, Z) = (beta*X, Y, Z).

    points (24, n) affine; s1, s2 (9, n) u32 limbs of |k1|, k2; neg1 (n,)
    sign of k1. 43 iterations of 3 doublings + two conditional table adds
    over odd-multiple tables {1..7}P (built with 3 dbl + 3 madd) and their
    endomorphism images (7 field muls): ~2250 Montgomery muls per lane.

    The table adds use doubling-free Jacobian addition. Soundness: acc's
    value in the GLV lattice is a + b*lambda with |a| <= 1.51*lambda + 7 and
    0 <= b <= lambda at every step; a collision acc == d*(+-P) or acc ==
    d*lambda*P requires a lattice vector (a', c) with a' + c*lambda = 0 mod
    r = lambda^2+lambda+1 in those ranges with c == 0 mod 8 (first add) or
    c in [-7, lambda] (second add) — enumeration of the short vectors
    ((lambda,-1), (1,lambda+1), (lambda+1,lambda), ...) shows none fits
    (lambda is odd, r - c*lambda > 2*lambda for c < lambda, and the c=1
    family needs a = -lambda which the clamped-positive k1 invariant of
    ops.glv.decompose excludes). Cancellation/infinity stay handled."""
    from curdleproofs_jax.ops.glv import beta_mont_limbs

    n = points.x.shape[-1]
    beta = _const_col(beta_mont_limbs())
    neg = neg1.astype(bool)
    base1 = APoints(points.x, _fsel(neg, _neg(points.y), points.y), points.inf)

    t1 = lift(base1)
    t2 = jdbl(t1)
    t3 = jmadd(t2, base1, handle_doubling=False)
    t4 = jdbl(t2)
    t5 = jmadd(t4, base1, handle_doubling=False)
    t6 = jdbl(t3)
    t7 = jmadd(t6, base1, handle_doubling=False)
    T1 = [t1, t2, t3, t4, t5, t6, t7]

    # phi is a homomorphism, so T2[k] = k*phi(P) = phi(k*P) = (beta*X, Y, Z)
    # of the table-1 entry — except table 1 carries sign(k1) while k2 is
    # always non-negative, so negate y back on the lanes where table 1 was
    # negated: phi(k*(-P)) = -k*phi(P).
    def endo(t):
        return JPoints(_mul(t.x, jnp.broadcast_to(beta, t.x.shape)),
                       _fsel(neg, _neg(t.y), t.y), t.z)

    T2 = [endo(t) for t in T1]
    # one zero row on top so the two-limb digit window never reads past
    s1p = jnp.concatenate([s1.astype(jnp.uint32), jnp.zeros((1, n), jnp.uint32)])
    s2p = jnp.concatenate([s2.astype(jnp.uint32), jnp.zeros((1, n), jnp.uint32)])

    def digit(s, bitpos):
        li = bitpos // 16
        lo = lax.dynamic_index_in_dim(s, li, axis=0, keepdims=False)
        hi = lax.dynamic_index_in_dim(s, li + 1, axis=0, keepdims=False)
        combined = lo | (hi << jnp.uint32(16))
        return (combined >> (bitpos % 16).astype(jnp.uint32)) & jnp.uint32(7)

    def tsel(T, d):
        t = T[0]
        for k in range(2, 8):
            t = jselect(d == k, T[k - 1], t)
        return t

    def body(i, acc):
        acc = jdbl(jdbl(jdbl(acc)))
        bitpos = 126 - 3 * i
        d1 = digit(s1p, bitpos)
        d2 = digit(s2p, bitpos)
        c1 = jadd(acc, tsel(T1, d1), handle_doubling=False)
        acc = jselect(d1 == 0, acc, c1)
        c2 = jadd(acc, tsel(T2, d2), handle_doubling=False)
        return jselect(d2 == 0, acc, c2)

    return lax.fori_loop(0, 43, body, jinf((n,)))


# The GLV ladder as its own program, run over fixed-width tiles: every
# engine that scales points on the accelerator (ladder MSMs, lockstep
# merges, vector scaling) shares ONE compilation whatever its width —
# compiling the ladder costs far more than running a padded tile.
glv_ladder = jax.jit(scalar_mul_glv)
GLV_TILE = 4096


def glv_scale(points: APoints, scalars_np) -> JPoints:
    """[k_i * P_i] (Jacobian, (24, n)) through the shared GLV ladder
    program, GLV_TILE lanes per call (identity lanes pad the last tile).
    scalars_np: host (16, n) canonical Fr limbs, split on the host
    (ops.glv.decompose)."""
    from curdleproofs_jax.ops import glv

    n = points.x.shape[-1]
    s1, neg1, s2 = glv.decompose(np.asarray(scalars_np).astype(np.uint64))
    m = -(-n // GLV_TILE) * GLV_TILE
    pad = m - n
    if pad:
        z = jnp.zeros((FQ_LIMBS, pad), jnp.uint32)
        points = APoints(
            jnp.concatenate([points.x, z], axis=-1),
            jnp.concatenate([points.y, z], axis=-1),
            jnp.concatenate([points.inf, jnp.ones(pad, bool)]),
        )
        s1 = np.pad(s1, ((0, 0), (0, pad)))
        s2 = np.pad(s2, ((0, 0), (0, pad)))
        neg1 = np.pad(neg1, (0, pad))
    outs = []
    for o in range(0, m, GLV_TILE):
        t = slice(o, o + GLV_TILE)
        outs.append(
            glv_ladder(
                APoints(points.x[:, t], points.y[:, t], points.inf[t]),
                jnp.asarray(s1[:, t]),
                jnp.asarray(neg1[t]),
                jnp.asarray(s2[:, t]),
            )
        )
    return JPoints(
        *(jnp.concatenate([getattr(r, f) for r in outs], axis=-1)[:, :n]
          for f in ("x", "y", "z"))
    )


def _const_col(limbs) -> jnp.ndarray:
    """(24,) constant limb vector -> (24, 1) column."""
    return ma._const(limbs).reshape(FQ_LIMBS, 1)


# ---------------------------------------------------------------------------
# host <-> device packing
# ---------------------------------------------------------------------------

import jax as _jax


@_jax.jit
def _to_affine_jit(p: JPoints) -> APoints:
    return to_affine(p)


@_jax.jit
def _pack72(x, y, z):
    return jnp.concatenate([x, y, z], axis=0)


def jpoints_to_host_packed(p: JPoints) -> List[G1]:
    """jpoints_to_host via ONE device-to-host transfer instead of three
    (one device-side concat -> one (72, ...) transfer)."""
    arr = np.asarray(_pack72(p.x, p.y, p.z))
    return jpoints_to_host(JPoints(arr[:24], arr[24:48], arr[48:]))


def _host_jacobians(p: JPoints) -> List[tuple]:
    """Device Jacobian points ((24,) or (24, n), Montgomery) -> host
    (X, Y, Z) int triples out of Montgomery form."""
    pmod = FQ_SPEC.modulus
    rinv = pow(FQ_SPEC.r_mod, -1, pmod)
    cols = [limbs_to_ints(np.asarray(c)) for c in (p.x, p.y, p.z)]
    if p.x.ndim == 1:
        cols = [[c] for c in cols]
    return [
        (x * rinv % pmod, y * rinv % pmod, z * rinv % pmod)
        for x, y, z in zip(*cols)
    ]


def jpoints_to_host(p: JPoints) -> List[G1]:
    """Normalize Jacobian device points ((24,) or (24, n)) to host G1.

    The affine conversion happens host-side in exact int arithmetic with
    ONE shared inversion (Montgomery's batch trick) instead of a 380-step
    batched Fermat inversion on device; device outputs stay Jacobian."""
    pmod = FQ_SPEC.modulus
    trip = _host_jacobians(p)
    zs = [z if z else 1 for _, _, z in trip]
    pref, acc = [0] * len(zs), 1
    for i, z in enumerate(zs):
        pref[i] = acc
        acc = acc * z % pmod
    inv = pow(acc, -1, pmod)
    out: List[G1] = [G1.identity()] * len(zs)
    for i in range(len(zs) - 1, -1, -1):
        zinv = inv * pref[i] % pmod
        inv = inv * zs[i] % pmod
        x, y, z = trip[i]
        if z:
            zinv2 = zinv * zinv % pmod
            out[i] = G1(x * zinv2 % pmod, y * zinv2 % pmod * zinv % pmod)
    return out


def sum_to_host(p: JPoints, K: int = 1) -> List[G1]:
    """Sums of K equal contiguous segments of a (24, n) device Jacobian
    vector, added on the host in Jacobian coordinates (n adds, no device
    reduction program to compile)."""
    from curdleproofs_jax.curve import _JINF, _jadd

    arr = np.asarray(_pack72(p.x, p.y, p.z))
    trip = _host_jacobians(JPoints(arr[:24], arr[24:48], arr[48:]))
    m = len(trip) // K
    out = []
    for k in range(K):
        acc = _JINF
        for t in trip[k * m : (k + 1) * m]:
            acc = _jadd(acc, t)
        out.append(G1._from_jacobian(acc))
    return out


def pack_points(points: List[G1]) -> APoints:
    """Host G1 list -> device affine struct (Montgomery form)."""
    R = FQ_SPEC.r_mod
    p = FQ_SPEC.modulus
    xs = [pt.x * R % p if not pt.inf else 0 for pt in points]
    ys = [pt.y * R % p if not pt.inf else 0 for pt in points]
    inf = np.array([pt.inf for pt in points], dtype=bool)
    return APoints(
        jnp.asarray(ints_to_limbs(xs, FQ_LIMBS)),
        jnp.asarray(ints_to_limbs(ys, FQ_LIMBS)),
        jnp.asarray(inf),
    )


def unpack_points(a: APoints) -> List[G1]:
    """Device affine struct -> host G1 list (out of Montgomery form)."""
    p = FQ_SPEC.modulus
    rinv = pow(FQ_SPEC.r_mod, -1, p)
    xs = limbs_to_ints(np.asarray(a.x))
    ys = limbs_to_ints(np.asarray(a.y))
    inf = np.asarray(a.inf)
    single = a.x.ndim == 1
    if single:
        xs, ys, inf = [xs], [ys], [inf]
    out = []
    for x, y, i in zip(xs, ys, np.atleast_1d(inf)):
        out.append(G1.identity() if bool(i) else G1(x * rinv % p, y * rinv % p))
    return out


def pack_scalars(scalars: List[Fr]) -> jnp.ndarray:
    """Host Fr list -> (16, N) canonical limb array."""
    return jnp.asarray(ints_to_limbs([s.v for s in scalars], FR_LIMBS))


def unpack_scalars(arr) -> List[Fr]:
    vals = limbs_to_ints(np.asarray(arr))
    if isinstance(vals, int):
        return [Fr(vals)]
    return [Fr(v) for v in vals]
