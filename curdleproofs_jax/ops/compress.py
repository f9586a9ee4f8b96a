"""Batched G1 point compression/decompression on device.

The Whisk verifier decodes 4*ell tracker points per proof (48-byte ZCash
compressed each; whisk_interface.py:96-100). Host-side decompression costs a
381-bit sqrt exponentiation per point; here the whole batch decompresses in
one jitted program: parse flags/x on host (cheap byte twiddling), then a
single batched Fermat/sqrt chain on device.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from curdleproofs_jax.curve import G1
from curdleproofs_jax.fields import FQ_MOD, FR_MOD
from curdleproofs_jax.ops import g1 as og
from curdleproofs_jax.ops import modarith as ma
from curdleproofs_jax.ops.fieldspec import FQ_SPEC, ints_to_limbs
from curdleproofs_jax.utils.errors import SerdeError

_P34 = (FQ_MOD + 1) // 4  # sqrt exponent (p ≡ 3 mod 4)
_HALF = (FQ_MOD - 1) // 2
_HALF_P1 = _HALF + 1  # compare y > (p-1)/2 via y - (half+1) borrow


@jax.jit
def _decompress_device(x_limbs: jnp.ndarray, sign_largest: jnp.ndarray):
    """x (24, n) canonical, sign flags (n,) bool -> (x_m, y_m (Montgomery),
    ok mask) with y chosen by lexicographic-largest flag."""
    xm = ma.to_mont(FQ_SPEC, x_limbs)
    x2 = ma.mont_sqr(FQ_SPEC, xm)
    x3 = ma.mont_mul(FQ_SPEC, x2, xm)
    four = ma.to_mont(
        FQ_SPEC,
        jnp.zeros_like(x_limbs).at[0].set(4),
    )
    rhs = ma.add(FQ_SPEC, x3, four)  # y^2 = x^3 + 4
    y = ma.mont_pow_const(FQ_SPEC, rhs, _P34)
    ok = ma.eq(FQ_SPEC, ma.mont_sqr(FQ_SPEC, y), rhs)  # sqrt existed
    # canonical y to decide lexicographic order
    y_can = ma.from_mont(FQ_SPEC, y)
    half_p1 = jnp.asarray(
        ints_to_limbs([_HALF_P1], FQ_SPEC.nlimbs), dtype=jnp.uint32
    )
    _, borrow = ma._sub_borrow(y_can, jnp.broadcast_to(half_p1, y_can.shape))
    is_largest = borrow == 0  # no borrow <=> y_can >= (p-1)/2 + 1 <=> y > (p-1)/2
    neg_y = ma.neg(FQ_SPEC, y)
    flip = is_largest != sign_largest
    y = jnp.where(flip[None, :], neg_y, y)
    return xm, y, ok


def batch_decompress(encodings: Sequence[bytes]) -> Tuple[og.APoints, List[bool]]:
    """Decode a batch of 48-byte compressed points (unchecked: no subgroup
    test, matching reference util.py:35-36). Raises SerdeError on malformed
    flag bytes / non-canonical x / non-residue (like the host decoder)."""
    n = len(encodings)
    xs: List[int] = []
    signs = np.zeros(n, dtype=bool)
    infs = np.zeros(n, dtype=bool)
    for i, data in enumerate(encodings):
        if len(data) != 48:
            raise SerdeError(f"encoding {i}: need 48 bytes, got {len(data)}")
        flags = data[0]
        if not flags & 0x80:
            raise SerdeError(f"encoding {i}: uncompressed form not supported")
        if flags & 0x40:
            if flags & 0x20 or any(data[1:]) or (flags & 0x1F):
                raise SerdeError(f"encoding {i}: malformed infinity")
            infs[i] = True
            xs.append(0)
            continue
        x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
        if x >= FQ_MOD:
            raise SerdeError(f"encoding {i}: x not canonical")
        xs.append(x)
        signs[i] = bool(flags & 0x20)

    x_limbs = jnp.asarray(ints_to_limbs(xs, FQ_SPEC.nlimbs))
    xm, ym, ok = _decompress_device(x_limbs, jnp.asarray(signs))
    ok_host = np.asarray(ok) | infs
    if not ok_host.all():
        bad = int(np.argmin(ok_host))
        raise SerdeError(f"encoding {bad}: x is not on the curve")
    return og.APoints(xm, ym, jnp.asarray(infs)), [bool(b) for b in infs]


def batch_decompress_to_host(encodings: Sequence[bytes]) -> List[G1]:
    """Batched decode straight to host G1 points."""
    ap, _ = batch_decompress(encodings)
    return og.unpack_points(ap)


@jax.jit
def _compress_device(p: og.APoints):
    x_can = ma.from_mont(FQ_SPEC, p.x)
    y_can = ma.from_mont(FQ_SPEC, p.y)
    half_p1 = jnp.asarray(ints_to_limbs([_HALF_P1], FQ_SPEC.nlimbs), dtype=jnp.uint32)
    _, borrow = ma._sub_borrow(y_can, jnp.broadcast_to(half_p1, y_can.shape))
    return x_can, borrow == 0


def batch_compress(p: og.APoints) -> List[bytes]:
    """Batched 48-byte ZCash compressed encoding of affine device points."""
    from curdleproofs_jax.ops.fieldspec import limbs_to_ints

    x_can, largest = _compress_device(p)
    xs = limbs_to_ints(np.asarray(x_can))
    if isinstance(xs, int):
        xs = [xs]
    infs = np.atleast_1d(np.asarray(p.inf))
    largest = np.atleast_1d(np.asarray(largest))
    out = []
    for x, inf, lg in zip(xs, infs, largest):
        if inf:
            out.append(bytes([0xC0]) + bytes(47))
            continue
        b = bytearray(int(x).to_bytes(48, "big"))
        b[0] |= 0x80
        if lg:
            b[0] |= 0x20
        out.append(bytes(b))
    return out
