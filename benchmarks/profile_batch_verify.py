#!/usr/bin/env python
"""Profile K-proof batched Whisk shuffle verification (where the wall goes).

Env: K (default 64), ELL (124), MODE (profile|time), WORKERS, FORCE_CPU
(1 pins JAX to the CPU; default 0 runs on the default backend).
"""
import cProfile
import io
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if os.environ.get("FORCE_CPU", "0") == "1":
    jax.config.update("jax_platforms", "cpu")


def main():
    K = int(os.environ.get("K", 64))
    ell = int(os.environ.get("ELL", 124))

    from curdleproofs_jax.curve import G1
    from curdleproofs_jax.models.crs import CurdleproofsCrs
    from curdleproofs_jax.models.whisk import (
        AreValidWhiskShuffleProofs,
        BLSPubkey,
        GenerateWhiskShuffleProof,
        IsValidWhiskShuffleProof,
        WhiskTracker,
    )
    from curdleproofs_jax.utils.rng import ProofRng

    prng = ProofRng(5)
    crs = CurdleproofsCrs.new(ell, 4, prng)
    gen = G1()
    pre = []
    for _ in range(ell):
        r_s, k_s = prng.random_scalar(), prng.random_scalar()
        r_G = gen * r_s
        pre.append(
            WhiskTracker(
                BLSPubkey(r_G.to_compressed_bytes()),
                BLSPubkey((r_G * k_s).to_compressed_bytes()),
            )
        )
    proofs = []
    t0 = time.perf_counter()
    for _ in range(K):
        post, proof = GenerateWhiskShuffleProof(crs, pre, prng)
        proofs.append((pre, post, proof))
    print(f"generated {K} proofs in {time.perf_counter() - t0:.1f}s")

    # warm (compiles, caches)
    assert AreValidWhiskShuffleProofs(crs, proofs[:2])

    t0 = time.perf_counter()
    ok = IsValidWhiskShuffleProof(crs, *proofs[0])
    t_single = time.perf_counter() - t0
    assert ok
    print(f"single verify: {t_single:.3f}s -> serial x{K}: {t_single * K:.3f}s")

    def run_batch():
        return AreValidWhiskShuffleProofs(crs, proofs)

    t0 = time.perf_counter()
    ok = run_batch()
    t_batch = time.perf_counter() - t0
    assert ok
    print(
        f"batch K={K}: {t_batch:.3f}s  speedup {t_single * K / t_batch:.2f}x"
    )

    if os.environ.get("MODE", "profile") == "profile":
        pr = cProfile.Profile()
        pr.enable()
        assert run_batch()
        pr.disable()
        s = io.StringIO()
        ps = pstats.Stats(pr, stream=s).sort_stats("cumulative")
        ps.print_stats(35)
        print(s.getvalue())


if __name__ == "__main__":
    main()
