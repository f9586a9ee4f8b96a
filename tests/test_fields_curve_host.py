"""Host field/curve conformance tests (the backend-contract suite, mirroring
reference test_curdleproofs.py:45-213 semantics against our own backend)."""
import random

import pytest

from curdleproofs_jax.fields import CURVE_ORDER, FQ_MOD, FR_MOD, Fr
from curdleproofs_jax.curve import (
    G1,
    G1_GENERATOR,
    G1_IDENTITY,
    fq_sqrt,
    g1_sum,
    msm_host,
)

rng = random.Random(0xC0FFEE)

GEN_COMPRESSED_HEX = (
    "97f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
    "6c55e83ff97a1aeffb3af00adb22c6bb"
)


def rand_fr() -> Fr:
    return Fr(rng.randrange(1, FR_MOD))


class TestFr:
    def test_constructor_reduces_any_size(self):
        assert int(Fr(CURVE_ORDER)) == 0
        assert int(Fr(2**256)) == 2**256 % CURVE_ORDER
        assert int(Fr(2**257)) == 2**257 % CURVE_ORDER
        assert int(Fr(CURVE_ORDER - 1)) == CURVE_ORDER - 1
        assert int(Fr(-1)) == CURVE_ORDER - 1

    def test_serde(self):
        assert Fr(4).to_le_bytes() == bytes.fromhex(
            "0400000000000000000000000000000000000000000000000000000000000000"
        )
        Fr.from_le_bytes((CURVE_ORDER - 1).to_bytes(32, "little"))
        with pytest.raises(ValueError):
            Fr.from_le_bytes(CURVE_ORDER.to_bytes(32, "little"))
        x = rand_fr()
        assert Fr.from_le_bytes(x.to_le_bytes()) == x

    def test_field_axioms_randomized(self):
        for _ in range(50):
            a, b, c = rand_fr(), rand_fr(), rand_fr()
            assert (a + b) * c == a * c + b * c
            assert a * b == b * a
            assert a - a == Fr(0)
            assert a + (-a) == Fr(0)
            assert a.square() == a * a
            assert a * a.inverse() == Fr(1)
            assert a ** 5 == a * a * a * a * a

    def test_inverse_of_zero_raises(self):
        with pytest.raises(ZeroDivisionError):
            Fr(0).inverse()

    def test_is_zero(self):
        assert Fr(0).is_zero() and not Fr(3).is_zero()


class TestG1:
    def test_generator_compressed_golden(self):
        # pinned by reference test_curdleproofs.py:179-180
        assert G1_GENERATOR.to_compressed_bytes().hex() == GEN_COMPRESSED_HEX
        assert G1() == G1_GENERATOR

    def test_decompress_roundtrip_checked_and_unchecked(self):
        data = bytes.fromhex(GEN_COMPRESSED_HEX)
        assert G1.from_compressed_bytes(data) == G1_GENERATOR
        assert G1.from_compressed_bytes_unchecked(data) == G1_GENERATOR

    def test_identity_encoding(self):
        enc = G1_IDENTITY.to_compressed_bytes()
        assert enc == bytes([0xC0]) + bytes(47)
        assert G1.from_compressed_bytes_unchecked(enc).is_identity()

    def test_group_axioms(self):
        g = G1_GENERATOR
        four = g * Fr(4)
        assert four == g + g + g + g
        assert g + G1_IDENTITY == g
        assert G1_IDENTITY + g == g
        assert g - g == G1_IDENTITY
        assert -(-g) == g
        assert (g * Fr(7)) + (g * Fr(8)) == g * Fr(15)

    def test_scalar_mul_randomized(self):
        g = G1_GENERATOR
        for _ in range(10):
            a, b = rand_fr(), rand_fr()
            assert (g * a) * b == g * (a * b)
            assert g * a + g * b == g * (a + b)

    def test_mul_by_zero_and_order(self):
        g = G1_GENERATOR
        assert (g * Fr(0)).is_identity()
        assert (g * Fr(CURVE_ORDER)).is_identity()
        assert g.in_subgroup()

    def test_points_on_curve_and_compress_roundtrip(self):
        for _ in range(10):
            p = G1_GENERATOR * rand_fr()
            assert p.is_on_curve()
            assert G1.from_compressed_bytes_unchecked(p.to_compressed_bytes()) == p

    def test_unhashable_like_reference_backend(self):
        with pytest.raises(TypeError):
            {G1_GENERATOR: True}

    def test_malformed_encodings_rejected(self):
        with pytest.raises(ValueError):
            G1.from_compressed_bytes_unchecked(bytes(48))  # no compression bit
        with pytest.raises(ValueError):
            G1.from_compressed_bytes_unchecked(bytes([0xC0]) + bytes(46) + b"\x01")
        with pytest.raises(ValueError):
            G1.from_compressed_bytes_unchecked(bytes(47))  # wrong length
        # x not on curve: x=1 gives 1+4=5; check residue status drives error
        x1 = (1).to_bytes(48, "big")
        b = bytearray(x1)
        b[0] |= 0x80
        if fq_sqrt(5) is None:
            with pytest.raises(ValueError):
                G1.from_compressed_bytes_unchecked(bytes(b))

    def test_sqrt(self):
        for _ in range(20):
            a = rng.randrange(FQ_MOD)
            sq = a * a % FQ_MOD
            s = fq_sqrt(sq)
            assert s is not None and s * s % FQ_MOD == sq

    def test_msm_host_matches_naive(self):
        n = 16
        bases = [G1_GENERATOR * rand_fr() for _ in range(n)]
        scalars = [rand_fr() for _ in range(n)]
        expect = G1_IDENTITY
        for b_, s_ in zip(bases, scalars):
            expect = expect + b_ * s_
        assert msm_host(bases, scalars) == expect
        assert g1_sum(bases) == msm_host(bases, [Fr(1)] * n)


def test_native_glv_backend_matches_pure_python():
    """The native backend's GLV decomposition + dual-table mul/MSM must
    agree with the pure-Python Jacobian oracle, including the Babai-clamp
    corner scalars (csrc/g1.c glv_decompose / j_mul_glv / msm_jpts)."""
    import random

    from curdleproofs_jax import curve as cv
    from curdleproofs_jax.ops.glv import LAMBDA

    rng = random.Random(17)
    pts = [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(12)] + [
        G1.identity()
    ]
    edge = [0, 1, 2, FR_MOD - 1, LAMBDA, LAMBDA + 1, LAMBDA - 1,
            FR_MOD // 2, (1 << 129) % FR_MOD, FR_MOD - LAMBDA]
    scs = [Fr(rng.randrange(FR_MOD)) for _ in range(3)] + [Fr(v) for v in edge]

    def oracle_mul(p, k):
        return G1._from_jacobian(cv._jmul(p._jacobian(), k))

    got = cv.mul_host_batch(pts, scs)
    for p, s, g in zip(pts, scs, got):
        assert g == oracle_mul(p, s.v), f"mul mismatch for {s!r}"

    acc = cv._JINF
    for p, s in zip(pts, scs):
        acc = cv._jadd(acc, cv._jmul(p._jacobian(), s.v))
    assert cv.msm_host(pts, scs) == G1._from_jacobian(acc)
    assert cv.msm_host(pts[:1], scs[:1]) == oracle_mul(pts[0], scs[0].v)
