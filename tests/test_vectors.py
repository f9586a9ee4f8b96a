"""Unit tests for the vector-first value types (curdleproofs_jax.vectors)
against the exact host oracles."""
import pytest

from curdleproofs_jax.curve import G1, g1_sum, msm_host
from curdleproofs_jax.fields import FR_MOD, Fr
from curdleproofs_jax.utils.rng import ProofRng
from curdleproofs_jax.vectors import PointVec, ScalarVec, as_points, as_scalars


@pytest.fixture
def rng():
    return ProofRng(123)


def test_scalarvec_construction_and_arith(rng):
    a = rng.blinders(9)
    b = rng.blinders(9)
    sa, sb = ScalarVec.of(a), ScalarVec.of(b)

    assert (sa + sb).tolist() == [x + y for x, y in zip(a, b)]
    assert (sa - sb).tolist() == [x - y for x, y in zip(a, b)]
    assert (sa * sb).tolist() == [x * y for x, y in zip(a, b)]
    assert (-sa).tolist() == [-x for x in a]
    k = rng.random_scalar()
    assert (sa * k).tolist() == [x * k for x in a]
    assert (sa + k).tolist() == [x + k for x in a]
    # int operands broadcast with mod reduction
    assert (sa * (FR_MOD + 2)).tolist() == [x * Fr(2) for x in a]


def test_scalarvec_reductions(rng):
    a = rng.blinders(8)
    b = rng.blinders(8)
    sa, sb = ScalarVec.of(a), ScalarVec.of(b)
    dot = Fr(0)
    prod = Fr(1)
    for x, y in zip(a, b):
        dot = dot + x * y
        prod = prod * x
    assert sa.dot(sb) == dot
    assert sa.product() == prod
    partials = sa.prefix_products().tolist()
    acc = Fr(1)
    for x, got in zip(a, partials):
        acc = acc * x
        assert got == acc


def test_scalarvec_powers_and_fill():
    beta = Fr(7)
    pows = ScalarVec.powers(beta, 6)
    assert pows.tolist() == [beta ** i for i in range(6)]
    assert ScalarVec.fill(beta, 3).tolist() == [beta] * 3


def test_scalarvec_batch_inversion(rng):
    a = rng.blinders(17)
    inv = ScalarVec.of(a).inverted().tolist()
    assert inv == [x.inverse() for x in a]
    with pytest.raises(ZeroDivisionError):
        ScalarVec.of([Fr(1), Fr(0), Fr(2)]).inverted()


def test_scalarvec_shape_ops(rng):
    a = rng.blinders(8)
    sa = ScalarVec.of(a)
    lo, hi = sa.split()
    assert lo.tolist() == a[:4] and hi.tolist() == a[4:]
    assert lo.cat(hi) == sa
    assert sa[2] == a[2]
    assert sa[1:3].tolist() == a[1:3]
    perm = [3, 1, 0, 2, 7, 6, 5, 4]
    assert sa.permuted(perm).tolist() == [a[i] for i in perm]


def _points(rng, n):
    g = G1()
    return [g * rng.random_scalar() for _ in range(n)]


def test_pointvec_group_ops(rng):
    pts = _points(rng, 10)
    qts = _points(rng, 10)
    pv, qv = PointVec(pts), PointVec(qts)
    scs = rng.blinders(10)

    assert pv.msm(ScalarVec.of(scs)) == msm_host(pts, scs)
    assert (pv + qv).tolist() == [p + q for p, q in zip(pts, qts)]
    assert pv.scaled(ScalarVec.of(scs)).tolist() == [
        p * s for p, s in zip(pts, scs)
    ]
    k = rng.random_scalar()
    assert pv.scaled(k).tolist() == [p * k for p in pts]
    assert pv.sum() == g1_sum(pts)

    gamma = rng.random_scalar()
    folded = pv.folded(gamma)
    assert folded.tolist() == [pts[i] + pts[5 + i] * gamma for i in range(5)]


def test_pointvec_shape_and_serde(rng):
    pts = _points(rng, 6) + [G1.identity()]
    pv = PointVec(pts)
    assert len(pv) == 7
    assert pv[6].is_identity()
    assert pv[:2].tolist() == pts[:2]
    assert pv.permuted([6, 0, 3]).tolist() == [pts[6], pts[0], pts[3]]
    assert pv.append(pts[0])[7] == pts[0]
    encs = pv.compressed()
    assert encs == [p.to_compressed_bytes() for p in pts]


def test_coercion_helpers(rng):
    pts = _points(rng, 3)
    pv = as_points(pts)
    assert as_points(pv) is pv
    sv = as_scalars([1, 2, 3])
    assert as_scalars(sv) is sv
    assert sv.tolist() == [Fr(1), Fr(2), Fr(3)]


def test_empty_and_mismatch(rng):
    assert PointVec([]).msm(ScalarVec.of([])) == G1.identity()
    with pytest.raises(ValueError):
        PointVec(_points(rng, 2)).msm(ScalarVec.of([Fr(1)]))
    with pytest.raises(ValueError):
        ScalarVec.of([Fr(1)]).dot(ScalarVec.of([Fr(1), Fr(2)]))
