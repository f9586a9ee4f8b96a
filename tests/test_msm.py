"""MSM engine tests: Pippenger sort-scan vs naive ladder vs host oracle."""
import random

import pytest

from curdleproofs_jax.curve import G1, msm_host
from curdleproofs_jax.fields import FR_MOD, Fr
from curdleproofs_jax.ops import g1 as og
from curdleproofs_jax.ops import msm as omsm
from curdleproofs_jax.ops import scan as oscan

rng = random.Random(0xABCD)


def rand_points(n):
    return [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(n)]


def rand_scalars(n):
    return [Fr(rng.randrange(FR_MOD)) for _ in range(n)]


def test_extract_digits_reconstructs_scalar():
    scs = rand_scalars(6) + [Fr(0), Fr(FR_MOD - 1)]
    for c in (4, 8, 13, 16):
        digits = omsm.extract_digits(og.pack_scalars(scs), c)
        W = digits.shape[0]
        for j, s in enumerate(scs):
            v = sum(int(digits[w, j]) << (c * w) for w in range(W))
            assert v == s.v, f"c={c} scalar {j}"


def test_pippenger_matches_oracle_with_edge_inputs():
    n = 32
    pts = rand_points(n)
    scs = rand_scalars(n)
    pts[0] = G1.identity()  # infinity base
    scs[1] = Fr(0)  # zero scalar
    pts[2] = pts[3]  # duplicate base (bucket doubling)
    scs[4] = scs[5] = Fr(7)  # duplicate digits everywhere
    pts[6] = -pts[7]
    assert omsm.msm(pts, scs, c=4) == msm_host(pts, scs)


def test_pippenger_various_window_sizes():
    n = 16
    pts, scs = rand_points(n), rand_scalars(n)
    expect = msm_host(pts, scs)
    for c in (4, 8, 11):
        assert omsm.msm(pts, scs, c=c) == expect, f"c={c}"


def test_pippenger_non_power_of_two_and_tiny():
    for n in (1, 3, 60):
        pts, scs = rand_points(n), rand_scalars(n)
        assert omsm.msm(pts, scs, c=4) == msm_host(pts, scs), f"n={n}"


def test_empty_msm():
    assert omsm.msm([], []).is_identity()


def test_naive_ladder_matches(monkeypatch):
    monkeypatch.setattr(og, "GLV_TILE", 8)  # one 8-lane ladder tile
    n = 8
    pts, scs = rand_points(n), rand_scalars(n)
    assert omsm.msm_naive(og.pack_points(pts), og.pack_scalars(scs)) == msm_host(
        pts, scs
    )


def test_scan_recursive_path(monkeypatch):
    # force the recursive Blelloch levels (SMALL_WIDTH below vector size)
    monkeypatch.setattr(oscan, "SMALL_WIDTH", 4)
    # 16 lanes exercises two recursive Blelloch levels above SMALL_WIDTH while
    # keeping the per-shape jadd compile count (the dominant cost) low
    pts = rand_points(16)
    jp = og.lift(og.pack_points(pts))
    got = og.unpack_points(og._to_affine_jit(oscan.inclusive_scan(jp)))
    acc = G1.identity()
    for i, p in enumerate(pts):
        acc = acc + p
        assert got[i] == acc, f"prefix {i}"
    total = og.unpack_points(og._to_affine_jit(oscan.tree_reduce_hybrid(jp)))[0]
    assert total == acc


def test_pippenger_small_window_batches():
    # exercise the window-chunking path (window_batch < W)
    n = 16
    pts, scs = rand_points(n), rand_scalars(n)
    got = omsm.msm_pippenger(
        og.pack_points(pts), og.pack_scalars(scs), c=8, window_batch=3
    )
    assert got == msm_host(pts, scs)


def test_msm_hostsort_matches_oracle():
    import numpy as np

    from curdleproofs_jax.ops.fieldspec import ints_to_limbs

    n = 96  # non-power-of-two; includes zero scalars and infinity points
    pts = rand_points(n - 2) + [G1.identity(), G1()]
    scs = rand_scalars(n - 3) + [Fr(0), Fr(0), Fr(5)]
    sc_np = np.asarray(ints_to_limbs([s.v for s in scs], 16), dtype=np.uint32)
    got = omsm.msm_pippenger_hostsort(og.pack_points(pts), sc_np, c=5)
    assert got == msm_host(pts, scs)


def test_msm_stream_matches_oracle():
    import numpy as np

    from curdleproofs_jax.ops.fieldspec import ints_to_limbs

    # non-power-of-two; exercises padding, zero scalars, infinity points,
    # duplicate points (madd doubling case inside the streaming scan), and
    # window chunking (window_batch < W)
    n = 100
    pts = rand_points(n - 4) + [G1.identity(), G1()] + [G1() * Fr(3)] * 2
    scs = rand_scalars(n - 3) + [Fr(0), Fr(0), Fr(5)]
    sc_np = np.asarray(ints_to_limbs([s.v for s in scs], 16), dtype=np.uint32)
    want = msm_host(pts, scs)
    got = omsm.msm_pippenger_stream(
        og.pack_points(pts), sc_np, c=8, window_batch=11
    )  # GLV split: W = 17 windows in two chunks, the second padded
    assert got == want


def test_msm_stream_sel_doubling_collision_falls_back(monkeypatch):
    """All-equal points/scalars: every lane's second record equals its
    running prefix, so the doubling-free scan of the direct stream path
    must flag the p == q collision and the engine must redo on the
    doubling-safe scan, still returning the exact result."""
    import numpy as np

    from curdleproofs_jax.ops import stream_scan as ostream
    from curdleproofs_jax.ops.fieldspec import ints_to_limbs

    monkeypatch.setattr(ostream, "pick_lanes", lambda n: min(32, n))
    n = 256
    p = G1() * Fr(11)
    pts = [p] * n
    scs = [Fr(7)] * n
    sc_np = np.asarray(ints_to_limbs([s.v for s in scs], 16), dtype=np.uint32)

    calls = {"safe": 0}
    orig = omsm._msm_stream_impl

    def spy(points, scalars_np, c, window_batch=None, device=None, _safe=False):
        if _safe:
            calls["safe"] += 1
        return orig(points, scalars_np, c, window_batch, device, _safe=_safe)

    monkeypatch.setattr(omsm, "_msm_stream_impl", spy)
    got = omsm.msm_pippenger_stream(og.pack_points(pts), sc_np, c=9)
    assert got == msm_host(pts, scs)
    assert calls["safe"] == 1, "doubling collision must trigger the safe redo"


def test_native_msm_prep_matches_numpy_pipeline():
    """C msm_prep_batch vs the numpy GLV+digits+sort+boundaries chain
    (both stable sorts of identical keys -> bit-identical tables)."""
    import numpy as np

    _g1n = pytest.importorskip("curdleproofs_jax._g1_native")
    if not hasattr(_g1n, "msm_prep_batch"):
        pytest.skip("stale native build")
    from curdleproofs_jax.ops import glv as oglv
    from curdleproofs_jax.ops.fieldspec import ints_to_limbs

    n, c, L = 512, 8, 64
    vals = [rng.randrange(FR_MOD) for _ in range(n - 2)] + [0, FR_MOD - 1]
    sc16 = np.asarray(ints_to_limbs(vals, 16), dtype=np.uint32)

    s1, neg_ref, s2 = oglv.decompose(sc16.astype(np.uint64))
    digits = omsm.host_digits(
        np.concatenate([s1, s2], axis=1).astype(np.uint32), c, bits=130
    )
    W = digits.shape[0]
    n2 = 2 * n
    ocm_ref, bidx_ref, lidx_ref, _ = omsm.stream_host_prep(digits, c, L)

    buf = np.ascontiguousarray(sc16.T.astype("<u2")).tobytes()
    nb, ob, bb, lb, _, _, _, Wn = _g1n.msm_prep_batch(buf, c, L)
    assert Wn == W
    assert np.array_equal(np.frombuffer(nb, np.uint8).astype(bool), neg_ref)
    assert np.array_equal(
        np.frombuffer(ob, np.int32).reshape(W, n2), ocm_ref
    )
    assert np.array_equal(
        np.frombuffer(bb, np.int32).reshape(W, -1), bidx_ref
    )
    assert np.array_equal(
        np.frombuffer(lb, np.int32).reshape(W, -1), lidx_ref
    )


def test_msm_stream_duplicate_runs():
    """Every point identical: the streaming scan's running prefix hits the
    madd doubling branch at (almost) every step."""
    import numpy as np

    from curdleproofs_jax.ops.fieldspec import ints_to_limbs

    n = 16
    p = G1() * Fr(11)
    pts = [p] * n
    scs = [Fr(1)] * n
    sc_np = np.asarray(ints_to_limbs([s.v for s in scs], 16), dtype=np.uint32)
    got = omsm.msm_pippenger_stream(og.pack_points(pts), sc_np, c=4)
    assert got == msm_host(pts, scs)


def test_msm_stream_glv_split_matches_oracle(monkeypatch):
    """GLV-split streaming path (lane doubling, W halved) vs both the
    non-split stream and the host oracle, including the decomposition's
    clamp corner (k near r-1 -> s1 positive up to 1.51*lambda) and the
    lambda boundaries."""
    import numpy as np

    from curdleproofs_jax.ops.fieldspec import ints_to_limbs
    from curdleproofs_jax.ops.glv import LAMBDA

    n = 60  # pads to 128 = GLV_STREAM_MIN_N
    pts = rand_points(n - 3) + [G1.identity(), G1()] + [G1() * Fr(3)]
    scs = rand_scalars(n - 6) + [
        Fr(0),
        Fr(1),
        Fr(FR_MOD - 1),
        Fr(LAMBDA),
        Fr(LAMBDA + 1),
        Fr(LAMBDA - 1),
    ]
    sc_np = np.asarray(ints_to_limbs([s.v for s in scs], 16), dtype=np.uint32)
    want = msm_host(pts, scs)
    monkeypatch.setattr(omsm, "STREAM_GLV", True)
    got_glv = omsm.msm_pippenger_stream(og.pack_points(pts), sc_np, c=8)
    assert got_glv == want
    monkeypatch.setattr(omsm, "STREAM_GLV", False)
    got_plain = omsm.msm_pippenger_stream(og.pack_points(pts), sc_np, c=8)
    assert got_plain == want


def test_msm_stream_split_matches_oracle(monkeypatch):
    """Widths above STREAM_SPLIT run as independent slices (MSM linearity)
    combined by host adds — forced at tiny size."""
    import numpy as np

    from curdleproofs_jax.ops.fieldspec import ints_to_limbs

    monkeypatch.setattr(omsm, "STREAM_SPLIT", 64)
    n = 200  # -> 4 slices: 64, 64, 64, 8(padded)
    pts = rand_points(n - 2) + [G1.identity(), G1() * Fr(3)]
    scs = rand_scalars(n - 1) + [Fr(0)]
    sc_np = np.asarray(ints_to_limbs([s.v for s in scs], 16), dtype=np.uint32)
    got = omsm.msm_pippenger_stream(og.pack_points(pts), sc_np)
    assert got == msm_host(pts, scs)


