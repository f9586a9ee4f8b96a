"""Host-facing batched point-vector operations.

The protocol layer (models/) orchestrates with exact host `G1`/`Fr` objects;
every O(n) point operation is dispatched here, where vectors are packed into
limb arrays, processed by the jitted device kernels, and unpacked. Widths are
padded to powers of two (min 32) so each kernel compiles for a handful of
shapes only (persistently cached).

These are the device replacements for the reference's per-element loops:
  * fold_points       — ipa.py:142-151 / same_msm.py:122-131 fold rounds
  * scale_points      — grand_prod.py:62-71 beta-power basis rescaling,
                        curdleproofs.py:310-313 tracker re-randomization
  * msm (ops.msm)     — msm_accumulator.py:6-12 compute_MSM
"""
from __future__ import annotations

from typing import List, Sequence

import jax
import numpy as np

from curdleproofs_jax.curve import G1
from curdleproofs_jax.fields import Fr
from curdleproofs_jax.ops import g1 as og
from curdleproofs_jax.ops.fieldspec import ints_to_limbs
from curdleproofs_jax.ops.g1 import APoints
from curdleproofs_jax.utils.profiling import timed

# Minimum padded width: protocol-sized vector ops share a few compiled shapes.
MIN_WIDTH = 128


def _pad_width(n: int) -> int:
    m = MIN_WIDTH
    while m < n:
        m *= 2
    return m


def _pack_padded(points: Sequence[G1], m: int) -> APoints:
    pts = list(points) + [G1.identity()] * (m - len(points))
    return og.pack_points(pts)


def _limbs_padded(scalars: Sequence[Fr], m: int) -> np.ndarray:
    ints = [s.v for s in scalars] + [0] * (m - len(scalars))
    return np.asarray(ints_to_limbs(ints, og.FR_LIMBS), dtype=np.uint32)


def _scaled(points: Sequence[G1], scalars: Sequence[Fr], m: int) -> og.JPoints:
    """[P_i * s_i] on device, padded to m lanes, through the shared GLV
    ladder program (og.glv_scale)."""
    return og.glv_scale(_pack_padded(points, m), _limbs_padded(scalars, m))


@jax.jit
def _madd_kernel(p: og.JPoints, a: APoints):
    return og.jmadd(p, a)


@jax.jit
def _add_kernel(a: APoints, b: APoints):
    return og.jmadd(og.lift(a), b)


def scale_points(points: Sequence[G1], scalars: Sequence[Fr]) -> List[G1]:
    """[P_i * s_i] with per-point scalars, batched on device."""
    n = len(points)
    if n != len(scalars):
        raise ValueError("scale_points length mismatch")
    if n == 0:
        return []
    m = _pad_width(n)
    with timed("vector.scale", items=n):
        return og.jpoints_to_host(_scaled(points, scalars, m))[:n]


def scale_points_common(points: Sequence[G1], k: Fr) -> List[G1]:
    """[P_i * k] with one common scalar (tracker re-randomization)."""
    return scale_points(points, [k] * len(points))


def fold_points(a: Sequence[G1], b: Sequence[G1], gamma: Fr) -> List[G1]:
    """[a_i + gamma * b_i] — the Bulletproofs-style fold round primitive."""
    n = len(a)
    if n != len(b):
        raise ValueError("fold_points length mismatch")
    if n == 0:
        return []
    m = _pad_width(n)
    with timed("vector.fold", items=n):
        res = _madd_kernel(_scaled(b, [gamma] * n, m), _pack_padded(a, m))
        return og.jpoints_to_host(res)[:n]


def fold_points_multi(
    a: Sequence[G1], b: Sequence[G1], gammas: Sequence[Fr]
) -> List[G1]:
    """[a_i + gammas_i * b_i] — fold with PER-ELEMENT scalars. Used by the
    lockstep batch prover, where K proofs' fold rounds merge into one
    dispatch and each segment carries its own challenge."""
    n = len(a)
    if n != len(b) or n != len(gammas):
        raise ValueError("fold_points_multi length mismatch")
    if n == 0:
        return []
    m = _pad_width(n)
    with timed("vector.fold", items=n):
        res = _madd_kernel(_scaled(b, gammas, m), _pack_padded(a, m))
        return og.jpoints_to_host(res)[:n]


def add_points(a: Sequence[G1], b: Sequence[G1]) -> List[G1]:
    """[a_i + b_i] elementwise."""
    n = len(a)
    if n != len(b):
        raise ValueError("add_points length mismatch")
    if n == 0:
        return []
    m = _pad_width(n)
    with timed("vector.add", items=n):
        res = _add_kernel(_pack_padded(a, m), _pack_padded(b, m))
        return og.jpoints_to_host(res)[:n]
