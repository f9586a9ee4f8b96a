"""Limb-level field specifications for the device kernels.

Field elements are vectors of 16-bit limbs held in uint32 lanes: products of
two limbs fit exactly in 32 bits and column accumulators keep >9 bits of
headroom (see ops.modarith).

Layout convention: **limb-major** — an array of N field elements has shape
(L, N) with the limb index on the leading axis and the batch on the trailing
axis, so every limb op vectorizes across the whole batch.

Two instances: FQ_SPEC (381-bit base field, 24 limbs) and FR_SPEC (255-bit
scalar field, 16 limbs). Montgomery radix R = 2^(16*L).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

from curdleproofs_jax.fields import FQ_MOD, FR_MOD

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def int_to_limbs(v: int, nlimbs: int) -> np.ndarray:
    """Scalar int -> (L,) uint32 limb vector (little-endian limbs)."""
    return np.array(
        [(v >> (LIMB_BITS * i)) & LIMB_MASK for i in range(nlimbs)], dtype=np.uint32
    )


def ints_to_limbs(vals, nlimbs: int) -> np.ndarray:
    """List of ints -> (L, N) uint32, limb-major."""
    buf = b"".join(int(v).to_bytes(2 * nlimbs, "little") for v in vals)
    arr = np.frombuffer(buf, dtype="<u2").reshape(len(vals), nlimbs)
    return np.ascontiguousarray(arr.T).astype(np.uint32)


def limbs_to_ints(arr) -> list:
    """(L, N) or (L,) uint32 limb-major (16-bit limbs) -> list of ints / int."""
    a = np.asarray(arr)
    single = a.ndim == 1
    if single:
        a = a[:, None]
    nlimbs, n = a.shape
    if a.size and a.max() > LIMB_MASK:
        raise ValueError("limbs_to_ints: limb wider than 16 bits")
    buf = np.ascontiguousarray(a.T.astype("<u2")).tobytes()
    w = 2 * nlimbs
    out = [int.from_bytes(buf[w * j : w * (j + 1)], "little") for j in range(n)]
    return out[0] if single else out


@dataclass(frozen=True)
class FieldSpec:
    """Static description of a prime field in limb form (hashable, so it can
    be a static argument to jitted kernels)."""

    name: str
    modulus: int
    nlimbs: int
    # derived, filled in __post_init__
    n0inv: int = field(init=False)
    r_mod: int = field(init=False)
    r2_mod: int = field(init=False)

    def __post_init__(self):
        radix = 1 << (LIMB_BITS * self.nlimbs)
        object.__setattr__(self, "n0inv", (-pow(self.modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS))
        object.__setattr__(self, "r_mod", radix % self.modulus)
        object.__setattr__(self, "r2_mod", radix * radix % self.modulus)

    # numpy constant views (cached; embedded as literals in jitted graphs)
    @functools.cached_property
    def mod_limbs(self) -> np.ndarray:
        return int_to_limbs(self.modulus, self.nlimbs)

    @functools.cached_property
    def one_mont(self) -> np.ndarray:
        return int_to_limbs(self.r_mod, self.nlimbs)

    @functools.cached_property
    def r2_limbs(self) -> np.ndarray:
        return int_to_limbs(self.r2_mod, self.nlimbs)

    @functools.cached_property
    def zero(self) -> np.ndarray:
        return np.zeros(self.nlimbs, dtype=np.uint32)

    def __hash__(self):
        return hash((self.name, self.modulus, self.nlimbs))


FQ_SPEC = FieldSpec("fq", FQ_MOD, 24)
FR_SPEC = FieldSpec("fr", FR_MOD, 16)
