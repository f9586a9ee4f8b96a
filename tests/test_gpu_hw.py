"""On-card correctness subset (runs on the GPU; skips elsewhere).

    CURDLEPROOFS_TEST_GPU=1 python -m pytest tests/test_gpu_hw.py -m gpu -v

`chip_smoke.py` runs the same file inside its own process. Every test checks
a device engine against the exact host oracle at n = 4096 (the lockstep and
DEVICE_MIN width) and the stream engine at 2^14 as well, exactly as the
card compiles them.
"""
import hashlib

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

N = 4096


@pytest.fixture(scope="module", autouse=True)
def _need_gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend (CURDLEPROOFS_TEST_GPU=1 on the card)")


def _inputs(n, tag):
    from curdleproofs_jax.curve import G1, mul_host_batch
    from curdleproofs_jax.fields import FR_MOD, Fr

    def h(s):
        return int.from_bytes(hashlib.sha256(s.encode()).digest(), "little")

    pts = mul_host_batch([G1()] * n, [Fr(h(f"{tag}p{i}") % FR_MOD) for i in range(n)])
    scs = [Fr(h(f"{tag}s{i}") % FR_MOD) for i in range(n)]
    return pts, scs


@pytest.fixture(scope="module")
def inputs():
    from curdleproofs_jax.curve import G1, msm_host
    from curdleproofs_jax.fields import Fr
    from curdleproofs_jax.ops import g1 as og
    from curdleproofs_jax.ops.fieldspec import ints_to_limbs

    pts, scs = _inputs(N, "hw")
    # edge lanes: identity base, zero scalar, duplicate point
    pts[7] = G1.identity()
    scs[9] = Fr(0)
    pts[11] = pts[10]
    expect = msm_host(pts, scs)
    packed = og.pack_points(pts)
    sc_np = np.asarray(ints_to_limbs([s.v for s in scs], 16), dtype=np.uint32)
    return pts, scs, packed, sc_np, expect


def test_ladder_msm_oracle(inputs):
    from curdleproofs_jax.ops import msm as omsm

    _, _, packed, sc_np, expect = inputs
    assert omsm.msm_ladder(packed, sc_np) == expect


def test_stream_msm_2e14_oracle():
    from curdleproofs_jax.curve import msm_host
    from curdleproofs_jax.fields import Fr
    from curdleproofs_jax.ops import g1 as og
    from curdleproofs_jax.ops import msm as omsm
    from curdleproofs_jax.ops.fieldspec import ints_to_limbs

    pts, scs = _inputs(1 << 14, "st")
    scs[5] = Fr(0)
    sc_np = np.asarray(ints_to_limbs([s.v for s in scs], 16), dtype=np.uint32)
    got = omsm.msm_pippenger_stream(og.pack_points(pts), sc_np)
    assert got == msm_host(pts, scs)


def test_stream_direct_msm_oracle(inputs):
    from curdleproofs_jax.ops import msm as omsm

    _, _, packed, sc_np, expect = inputs
    assert omsm.msm_pippenger_stream(packed, sc_np, c=8) == expect


def test_hostsort_msm_oracle(inputs):
    from curdleproofs_jax.ops import msm as omsm

    _, _, packed, sc_np, expect = inputs
    assert omsm.msm_pippenger_hostsort(packed, sc_np, c=8) == expect


def test_segmented_ladder_oracle(inputs):
    """The lockstep batch-proving engine: K same-width MSMs, one dispatch."""
    from curdleproofs_jax.curve import msm_host
    from curdleproofs_jax.ops import msm as omsm

    pts, scs, packed, sc_np, _ = inputs
    K = 4
    m = N // K
    got = omsm.msm_ladder_segmented(packed, sc_np, K)
    for k in range(K):
        want = msm_host(pts[k * m : (k + 1) * m], scs[k * m : (k + 1) * m])
        assert got[k] == want, f"segment {k}"


def test_fused_point_kernels_oracle(inputs):
    """scale / fold / add vector kernels vs exact host."""
    from curdleproofs_jax.curve import add_host_batch, mul_host_batch
    from curdleproofs_jax.fields import Fr
    from curdleproofs_jax.ops import vector as ovec

    pts, scs, _, _, _ = inputs
    a, b, ss = pts[:512], pts[512:1024], scs[:512]
    assert ovec.scale_points(a, ss) == mul_host_batch(a, ss)
    assert ovec.add_points(a, b) == add_host_batch(a, b)
    g = Fr(12345)
    want = add_host_batch(a, mul_host_batch(b, [g] * 512))
    assert ovec.fold_points(a, b, g) == want
