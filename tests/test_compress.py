"""Batched device point (de)compression vs the exact host serde."""
import random

import pytest

from curdleproofs_jax.curve import G1
from curdleproofs_jax.fields import FR_MOD, Fr
from curdleproofs_jax.ops import g1 as og
from curdleproofs_jax.ops.compress import (
    batch_compress,
    batch_decompress_to_host,
)
from curdleproofs_jax.utils.errors import SerdeError

rng = random.Random(0x51DE)


def rand_points(n):
    return [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(n)]


def test_batch_decompress_matches_host():
    pts = rand_points(16)
    pts[3] = G1.identity()
    encs = [p.to_compressed_bytes() for p in pts]
    got = batch_decompress_to_host(encs)
    assert got == pts


def test_batch_compress_matches_host():
    pts = rand_points(16)
    pts[5] = G1.identity()
    ap = og.pack_points(pts)
    encs = batch_compress(ap)
    assert encs == [p.to_compressed_bytes() for p in pts]


def test_round_trip_both_signs():
    # force both lexicographic sign cases
    p = G1() * Fr(7)
    pts = [p, -p]
    encs = [q.to_compressed_bytes() for q in pts]
    assert encs[0] != encs[1]
    assert batch_decompress_to_host(encs) == pts


def test_malformed_batch_rejected():
    good = (G1() * Fr(3)).to_compressed_bytes()
    with pytest.raises(SerdeError):
        batch_decompress_to_host([good, bytes(48)])  # missing compression bit
    with pytest.raises(SerdeError):
        batch_decompress_to_host([good[:-1]])  # wrong length
    # x not on curve: x = 1 (1 + 4 = 5 is a QNR for BLS12-381)
    bad = bytearray((1).to_bytes(48, "big"))
    bad[0] |= 0x80
    from curdleproofs_jax.curve import fq_sqrt

    if fq_sqrt(5) is None:
        with pytest.raises(SerdeError):
            batch_decompress_to_host([bytes(bad)])
