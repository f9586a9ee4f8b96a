"""The take-based gathers and the direct streaming MSM engine vs oracles."""
import random

import jax.numpy as jnp
import numpy as np
import pytest

from curdleproofs_jax.curve import G1, msm_host
from curdleproofs_jax.fields import FR_MOD, Fr
from curdleproofs_jax.ops import g1 as og
from curdleproofs_jax.ops import gather as ogather
from curdleproofs_jax.ops import msm as omsm
from curdleproofs_jax.ops import stream_scan as ostream
from curdleproofs_jax.ops.fieldspec import ints_to_limbs

rng = random.Random(0x57E4)


@pytest.mark.parametrize(
    "W,N,M",
    [(1, 64, 40), (3, 64, 40), (2, 37, 13)],
    ids=["one-window", "many-windows", "odd-widths"],
)
def test_take_gather_exact(W, N, M):
    """gather_u32 (per-window tables) and gather_u32_shared (one table)
    vs numpy, with out-of-range indices on both sides gathering 0."""
    g = np.random.default_rng(W * 1000 + N)
    table = g.integers(0, 1 << 32, (5, W, N), dtype=np.uint32)
    idx = g.integers(-3, N + 3, (W, M)).astype(np.int32)
    want = np.zeros((5, W, M), np.uint32)
    for w in range(W):
        for j in range(M):
            if 0 <= idx[w, j] < N:
                want[:, w, j] = table[:, w, idx[w, j]]
    got = np.asarray(ogather.gather_u32(jnp.asarray(table), jnp.asarray(idx)))
    assert np.array_equal(got, want)

    shared = table[:, 0, :]
    want_s = np.zeros((5, W, M), np.uint32)
    for w in range(W):
        for j in range(M):
            if 0 <= idx[w, j] < N:
                want_s[:, w, j] = shared[:, idx[w, j]]
    got_s = np.asarray(
        ogather.gather_u32_shared(jnp.asarray(shared), jnp.asarray(idx))
    )
    assert np.array_equal(got_s, want_s)


@pytest.mark.parametrize(
    "n,c,window_batch,glv,lanes",
    [
        (300, 8, None, True, None),
        (200, 6, [7, 9], False, None),
        (256, 10, 2, True, 64),
        (129, 5, 100, False, 32),
    ],
    ids=["glv-default", "plain-schedule", "glv-narrow-lanes", "plain-one-chunk"],
)
def test_stream_engine_matches_oracle(monkeypatch, n, c, window_batch, glv, lanes):
    """The direct stream engine (take gather, doubling-free scan, boundary
    stitch) over window bits, chunk schedules, the GLV split on and off,
    and the production lane rule or a forced narrow one; padding, zero
    scalars and identity bases included."""
    monkeypatch.setattr(omsm, "STREAM_GLV", glv)
    if lanes is not None:
        monkeypatch.setattr(ostream, "pick_lanes", lambda m: min(lanes, m))
    pts = [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(n - 1)]
    pts.append(G1.identity())
    scs = [Fr(rng.randrange(FR_MOD)) for _ in range(n - 2)] + [Fr(0), Fr(1)]
    sc_np = np.asarray(ints_to_limbs([s.v for s in scs], 16), dtype=np.uint32)
    got = omsm.msm_pippenger_stream(
        og.pack_points(pts), sc_np, c=c, window_batch=window_batch
    )
    assert got == msm_host(pts, scs)
