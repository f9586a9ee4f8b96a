"""Batched G1 device kernels vs the exact host oracle, incl. edge cases."""
import random

import jax
import jax.numpy as jnp
import pytest

from curdleproofs_jax.curve import G1, msm_host
from curdleproofs_jax.fields import FR_MOD, Fr
from curdleproofs_jax.ops import g1 as og
from curdleproofs_jax.ops import modarith as ma
from curdleproofs_jax.ops import scan as oscan
from curdleproofs_jax.ops.fieldspec import FQ_SPEC

rng = random.Random(0xBEEF)


def rand_points(n):
    pts = [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(n)]
    return pts


def rand_scalars(n):
    return [Fr(rng.randrange(FR_MOD)) for _ in range(n)]


@pytest.fixture(scope="module")
def pts8():
    pts = rand_points(8)
    pts[3] = G1.identity()
    return pts


def unpack_j(jp):
    return og.unpack_points(og._to_affine_jit(jp))


def test_pack_unpack_roundtrip(pts8):
    assert og.unpack_points(og.pack_points(pts8)) == pts8


def test_jadd_matches_host(pts8):
    qs = rand_points(8)
    jp, jq = og.lift(og.pack_points(pts8)), og.lift(og.pack_points(qs))
    f = jax.jit(og.jadd)
    assert unpack_j(f(jp, jq)) == [p + q for p, q in zip(pts8, qs)]


def test_jadd_edge_cases(pts8):
    jp = og.lift(og.pack_points(pts8))
    f = jax.jit(og.jadd)
    # P + P (doubling branch)
    assert unpack_j(f(jp, jp)) == [p + p for p in pts8]
    # P + (-P) -> infinity
    jneg = og.JPoints(jp.x, ma.neg(FQ_SPEC, jp.y), jp.z)
    assert all(p.is_identity() for p in unpack_j(f(jp, jneg)))
    # inf + P and P + inf
    inf = og.jinf((8,))
    assert unpack_j(f(inf, jp)) == pts8
    assert unpack_j(f(jp, inf)) == pts8


def test_jmadd_matches_and_edges(pts8):
    qs = rand_points(8)
    qs[5] = G1.identity()
    jp = og.lift(og.pack_points(pts8))
    aq = og.pack_points(qs)
    f = jax.jit(og.jmadd)
    assert unpack_j(f(jp, aq)) == [p + q for p, q in zip(pts8, qs)]
    # doubling case via affine: p == q
    same = og.pack_points(pts8)
    assert unpack_j(f(jp, same)) == [p + p for p in pts8]


def test_jdbl(pts8):
    jp = og.lift(og.pack_points(pts8))
    assert unpack_j(jax.jit(og.jdbl)(jp)) == [p + p for p in pts8]


def test_scalar_mul_per_lane(pts8, monkeypatch):
    """Per-lane k_i * P_i through og.glv_scale (the GLV ladder program)."""
    import numpy as np

    from curdleproofs_jax.ops.fieldspec import ints_to_limbs

    monkeypatch.setattr(og, "GLV_TILE", 8)
    scs = rand_scalars(8)
    scs[0], scs[1] = Fr(0), Fr(1)
    sc_np = np.asarray(ints_to_limbs([s.v for s in scs], 16), dtype=np.uint32)
    res = og.glv_scale(og.pack_points(pts8), sc_np)
    assert unpack_j(res) == [p * s for p, s in zip(pts8, scs)]


def test_tree_reduce_and_scan():
    for n in (1, 2, 5, 8, 16):
        pts = rand_points(n)
        jp = og.lift(og.pack_points(pts))
        total = unpack_j(jax.jit(oscan.tree_reduce_hybrid)(jp))[0]
        expect = G1.identity()
        for p in pts:
            expect = expect + p
        assert total == expect, f"reduce n={n}"


def test_inclusive_scan_prefixes():
    n = 16
    pts = rand_points(n)
    pts[7] = G1.identity()
    jp = og.lift(og.pack_points(pts))
    scanned = jax.jit(oscan.inclusive_scan)(jp)
    got = unpack_j(scanned)
    acc = G1.identity()
    for i, p in enumerate(pts):
        acc = acc + p
        assert got[i] == acc, f"prefix {i}"


def test_scalar_pack_roundtrip():
    scs = rand_scalars(5)
    assert og.unpack_scalars(og.pack_scalars(scs)) == scs
