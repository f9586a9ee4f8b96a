"""Device limb arithmetic vs exact Python-int oracle (both fields)."""
import random

import jax
import pytest

from curdleproofs_jax.ops import modarith as ma
from curdleproofs_jax.ops.fieldspec import (
    FQ_SPEC,
    FR_SPEC,
    int_to_limbs,
    ints_to_limbs,
    limbs_to_ints,
)

rng = random.Random(0xFEED)
N = 64


@pytest.fixture(scope="module", params=[FQ_SPEC, FR_SPEC], ids=["fq", "fr"])
def spec(request):
    return request.param


def _rand_batch(spec, n=N, include_edges=True):
    p = spec.modulus
    xs = [rng.randrange(p) for _ in range(n)]
    if include_edges:
        xs[:4] = [0, 1, p - 1, p // 2]
    return xs


def test_limb_roundtrip(spec):
    xs = _rand_batch(spec)
    assert limbs_to_ints(ints_to_limbs(xs, spec.nlimbs)) == xs
    assert limbs_to_ints(int_to_limbs(xs[5], spec.nlimbs)) == xs[5]


def test_add_sub_neg(spec):
    p = spec.modulus
    xs, ys = _rand_batch(spec), _rand_batch(spec)
    X, Y = ints_to_limbs(xs, spec.nlimbs), ints_to_limbs(ys, spec.nlimbs)
    add = jax.jit(lambda a, b: ma.add(spec, a, b))
    sub = jax.jit(lambda a, b: ma.sub(spec, a, b))
    neg = jax.jit(lambda a: ma.neg(spec, a))
    assert limbs_to_ints(add(X, Y)) == [(x + y) % p for x, y in zip(xs, ys)]
    assert limbs_to_ints(sub(X, Y)) == [(x - y) % p for x, y in zip(xs, ys)]
    assert limbs_to_ints(neg(X)) == [(-x) % p for x in xs]


def test_mont_mul_and_conversions(spec):
    p = spec.modulus
    R = 1 << (16 * spec.nlimbs)
    Rinv = pow(R, -1, p)
    xs, ys = _rand_batch(spec), _rand_batch(spec)
    X, Y = ints_to_limbs(xs, spec.nlimbs), ints_to_limbs(ys, spec.nlimbs)
    mul = jax.jit(lambda a, b: ma.mont_mul(spec, a, b))
    assert limbs_to_ints(mul(X, Y)) == [x * y * Rinv % p for x, y in zip(xs, ys)]
    tm = jax.jit(lambda a: ma.to_mont(spec, a))
    fm = jax.jit(lambda a: ma.from_mont(spec, a))
    Xm = tm(X)
    assert limbs_to_ints(Xm) == [x * R % p for x in xs]
    assert limbs_to_ints(fm(Xm)) == xs


def test_mont_mul_worst_case_carries(spec):
    # all-ones limbs and p-1 squared exercise maximal column accumulation
    p = spec.modulus
    R = 1 << (16 * spec.nlimbs)
    Rinv = pow(R, -1, p)
    xs = [p - 1, p - 1, (1 << (16 * spec.nlimbs - 1)) % p, 0]
    ys = [p - 1, 1, p - 2, p - 1]
    X, Y = ints_to_limbs(xs, spec.nlimbs), ints_to_limbs(ys, spec.nlimbs)
    got = limbs_to_ints(ma.mont_mul(spec, X, Y))
    assert got == [x * y * Rinv % p for x, y in zip(xs, ys)]


def test_inverse(spec):
    p = spec.modulus
    xs = _rand_batch(spec, n=8, include_edges=False)
    X = ints_to_limbs(xs, spec.nlimbs)
    inv = jax.jit(lambda a: ma.from_mont(spec, ma.mont_inv(spec, ma.to_mont(spec, a))))
    assert limbs_to_ints(inv(X)) == [pow(x, -1, p) for x in xs]


def test_pow_const(spec):
    p = spec.modulus
    e = 0xDEADBEEFCAFE
    xs = _rand_batch(spec, n=8)
    X = ints_to_limbs(xs, spec.nlimbs)
    f = jax.jit(
        lambda a: ma.from_mont(spec, ma.mont_pow_const(spec, ma.to_mont(spec, a), e))
    )
    assert limbs_to_ints(f(X)) == [pow(x, e, p) for x in xs]


def test_predicates(spec):
    xs = [0, 1, spec.modulus - 1, 7]
    X = ints_to_limbs(xs, spec.nlimbs)
    assert list(ma.is_zero(spec, X)) == [True, False, False, False]
    assert list(ma.eq(spec, X, X)) == [True] * 4


def test_unrolled_path_matches_looped(spec):
    p = spec.modulus
    R = 1 << (16 * spec.nlimbs)
    Rinv = pow(R, -1, p)
    xs, ys = _rand_batch(spec, n=16), _rand_batch(spec, n=16)
    X, Y = ints_to_limbs(xs, spec.nlimbs), ints_to_limbs(ys, spec.nlimbs)
    got = limbs_to_ints(ma._mont_mul_vec(spec, X, Y))
    assert got == [x * y * Rinv % p for x, y in zip(xs, ys)]
    assert got == limbs_to_ints(ma._mont_mul_looped(spec, X, Y))


def test_in_kernel_mul_formulations_agree():
    """The "vec" form (the GPU's) vs the looped form (the CPU's) on random
    inputs, including edge values near the modulus, and mont_mul/mont_sqr
    dispatch under each limb mode."""
    import jax.numpy as jnp
    import numpy as np

    from curdleproofs_jax.ops.fieldspec import FQ_SPEC, ints_to_limbs, limbs_to_ints

    rng_ = np.random.default_rng(11)
    p = FQ_SPEC.modulus
    vals_a = [0, 1, p - 1, p - 2, (p - 1) // 2] + [
        int.from_bytes(rng_.bytes(47), "little") % p for _ in range(11)
    ]
    vals_b = [p - 1, 0, p - 1, 17, (p + 1) // 2] + [
        int.from_bytes(rng_.bytes(47), "little") % p for _ in range(11)
    ]
    a = jnp.asarray(ints_to_limbs(vals_a, FQ_SPEC.nlimbs))
    b = jnp.asarray(ints_to_limbs(vals_b, FQ_SPEC.nlimbs))
    want_mul = limbs_to_ints(np.asarray(ma._mont_mul_looped(FQ_SPEC, a, b)))
    want_sqr = limbs_to_ints(np.asarray(ma._mont_mul_looped(FQ_SPEC, a, a)))
    assert limbs_to_ints(np.asarray(ma._mont_mul_vec(FQ_SPEC, a, b))) == want_mul
    for mode in ma.LIMB_MODES:
        with ma.limb_mode_override(mode):
            assert ma.limb_mode() == mode
            got = limbs_to_ints(np.asarray(ma.mont_mul(FQ_SPEC, a, b)))
            gs = limbs_to_ints(np.asarray(ma.mont_sqr(FQ_SPEC, a)))
        assert got == want_mul, mode
        assert gs == want_sqr, mode


def test_vec_form_carry_chains(spec):
    """The "vec" limb form (lookahead carries, no limb loop) on structured
    operands whose limbs are all-ones or all-zero runs (the longest carry
    and borrow chains), vs exact ints; plus _normalize_vec on columns built
    from 0xFFFF / 0x10000 runs."""
    import numpy as np

    p = spec.modulus
    L = spec.nlimbs
    R = 1 << (16 * L)
    Rinv = pow(R, -1, p)
    st = []
    for j in range(1, L + 1, 3):
        st += [
            ((1 << (16 * j)) - 1) % p,
            (p - (1 << (16 * (j - 1)))) % p,
            (p - 1 - ((1 << (16 * j)) - 1)) % p,
        ]
    xs = [a for a in st for _ in st]
    ys = [b for _ in st for b in st]
    X, Y = ints_to_limbs(xs, L), ints_to_limbs(ys, L)
    with ma.limb_mode_override("vec"):
        mul = limbs_to_ints(np.asarray(jax.jit(lambda a, b: ma.mont_mul(spec, a, b))(X, Y)))
        add = limbs_to_ints(np.asarray(jax.jit(lambda a, b: ma.add(spec, a, b))(X, Y)))
        sub = limbs_to_ints(np.asarray(jax.jit(lambda a, b: ma.sub(spec, a, b))(X, Y)))
    assert mul == [x * y * Rinv % p for x, y in zip(xs, ys)]
    assert add == [(x + y) % p for x, y in zip(xs, ys)]
    assert sub == [(x - y) % p for x, y in zip(xs, ys)]

    g = np.random.default_rng(L)
    cols = g.choice(
        np.array([0, 0xFFFF, 0x10000, 0xFFFE, 1 << 22], np.uint32), (2 * L, 64)
    )
    with ma.limb_mode_override("vec"):
        limbs, carry = ma._normalize_vec(jax.numpy.asarray(cols), passes=2)
    limbs, carry = np.asarray(limbs), np.asarray(carry)
    assert limbs.max() <= 0xFFFF
    for j in range(64):
        want = sum(int(cols[k, j]) << (16 * k) for k in range(2 * L))
        got = sum(int(limbs[k, j]) << (16 * k) for k in range(2 * L))
        assert got + (int(carry[j]) << (32 * L)) == want
