"""GLV endomorphism decomposition (ops.glv) and the dual-table ladder.

The decomposition feeds the GLV ladder (ops.g1.scalar_mul_glv) and the
GLV-split stream MSM; its invariants (|k1| bounds, sign structure) are
load-bearing for the ladder's doubling-free-add soundness proof, so they are
asserted here explicitly.
"""
import random

import numpy as np

from curdleproofs_jax.fields import FR_MOD, Fr
from curdleproofs_jax.curve import G1
from curdleproofs_jax.ops import glv
from curdleproofs_jax.ops.fieldspec import ints_to_limbs

rng = random.Random(29)


def _limbs_to_int(col):
    return sum(int(col[i]) << (16 * i) for i in range(len(col)))


EDGES = [
    0,
    1,
    2,
    7,
    FR_MOD - 1,
    FR_MOD - 2,
    FR_MOD - 7,
    glv.LAMBDA,
    glv.LAMBDA - 1,
    glv.LAMBDA + 1,
    glv.Z_ABS**2,
    (1 << 254) - 1,
    1 << 128,
    14 * glv.LAMBDA,
]


def test_lattice_identity():
    assert glv.LAMBDA**2 + glv.LAMBDA + 1 == FR_MOD


def test_beta_lambda_pairing():
    """phi(x, y) = (beta*x, y) must equal lambda * (x, y) on G1."""
    from curdleproofs_jax.ops.fieldspec import FQ_SPEC

    q = FQ_SPEC.modulus
    assert pow(glv.BETA, 3, q) == 1 and glv.BETA != 1
    for _ in range(3):
        P = G1() * Fr(rng.randrange(1, FR_MOD))
        assert G1(P.x * glv.BETA % q, P.y) == P * Fr(glv.LAMBDA)


def test_decompose_matches_int_reference_and_invariants():
    ks = EDGES + [rng.randrange(FR_MOD) for _ in range(512)]
    s1, neg1, s2 = glv.decompose(np.asarray(ints_to_limbs(ks, 16)))
    for j, k in enumerate(ks):
        k1 = _limbs_to_int(s1[:, j]) * (-1 if neg1[j] else 1)
        k2 = _limbs_to_int(s2[:, j])
        rk1, rk2 = glv.decompose_int(k)
        assert (k1, k2) == (rk1, rk2)
        # reconstruction
        assert (k1 + k2 * glv.LAMBDA) % FR_MOD == k
        # ladder soundness invariants (ops.g1.scalar_mul_glv)
        assert abs(k1) < 1 << 129
        assert 0 <= k2 <= glv.LAMBDA
        if abs(k1) > glv.LAMBDA // 2 + 1:
            assert k1 > 0 and k2 == glv.LAMBDA  # clamped corner: positive k1


def test_decompose_rejects_nothing_valid():
    """Every canonical scalar decomposes (no assertion trips) — sweep a
    few structured families."""
    fams = [glv.LAMBDA * t % FR_MOD for t in range(1, 50)]
    fams += [(glv.LAMBDA + 1) * t % FR_MOD for t in range(1, 50)]
    s1, neg1, s2 = glv.decompose(np.asarray(ints_to_limbs(fams, 16)))
    for j, k in enumerate(fams):
        k1 = _limbs_to_int(s1[:, j]) * (-1 if neg1[j] else 1)
        k2 = _limbs_to_int(s2[:, j])
        assert (k1 + k2 * glv.LAMBDA) % FR_MOD == k


def test_glv_kernel_interpret_matches_host(monkeypatch):
    """XLA GLV dual-table ladder (og.scalar_mul_glv) through og.glv_scale's
    fixed-width tiles (two 64-lane tiles here) vs exact host arithmetic,
    including identity points and edge scalars; and og.sum_to_host's
    segment sums of its output."""
    from curdleproofs_jax.curve import msm_host
    from curdleproofs_jax.ops import g1 as og

    monkeypatch.setattr(og, "GLV_TILE", 64)

    n = 128
    pts = [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(n)]
    pts[3] = G1.identity()
    scs = [Fr(rng.randrange(FR_MOD)) for _ in range(n)]
    for i, e in enumerate(EDGES):
        scs[i] = Fr(e % FR_MOD)
    n = 120  # pads the second tile
    pts, scs = pts[:n], scs[:n]
    acc = og.glv_scale(
        og.pack_points(pts), np.asarray(ints_to_limbs([s.v for s in scs], 16))
    )
    assert og.jpoints_to_host(acc) == [p * s for p, s in zip(pts, scs)]
    assert og.sum_to_host(acc, 2) == [
        msm_host(pts[:60], scs[:60]),
        msm_host(pts[60:], scs[60:]),
    ]
