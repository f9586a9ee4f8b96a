#!/usr/bin/env python
"""Run the five BASELINE.md benchmark configs and emit a JSON report.

  1. ell=60 (n=64) shuffle prove+verify (reference test-vector size)
  2. standalone MSM sweep n=2^12..2^20, one device
  3. ell=124 (n=128) Whisk-spec shuffle prove+verify, single host
  4. batched verification: K proofs via one aggregated MSM
  5. sharded MSM (points partitioned over available devices)

Usage: python benchmarks/run_all.py [--quick]
Writes benchmarks/report.json and prints a summary line per config.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_trackers(ell, rng):
    from curdleproofs_jax.curve import G1
    from curdleproofs_jax.models.whisk import BLSPubkey, WhiskTracker

    gen = G1()
    out = []
    for _ in range(ell):
        r = rng.random_scalar()
        k = rng.random_scalar()
        r_G = gen * r
        out.append(
            WhiskTracker(
                BLSPubkey(r_G.to_compressed_bytes()),
                BLSPubkey((r_G * k).to_compressed_bytes()),
            )
        )
    return out


def bench_shuffle(ell, n_blinders, seed, warm=True):
    from curdleproofs_jax.models.crs import CurdleproofsCrs
    from curdleproofs_jax.models.whisk import (
        GenerateWhiskShuffleProof,
        IsValidWhiskShuffleProof,
    )
    from curdleproofs_jax.utils.rng import ProofRng

    rng = ProofRng(seed)
    crs = CurdleproofsCrs.new(ell, n_blinders, rng)
    pre = build_trackers(ell, rng)

    cold_prove = cold_verify = None
    if warm:  # first pass pays all jit compiles; report it separately
        t0 = time.time()
        post_w, proof_w = GenerateWhiskShuffleProof(crs, pre, rng)
        cold_prove = round(time.time() - t0, 3)
        t0 = time.time()
        assert IsValidWhiskShuffleProof(crs, pre, post_w, proof_w)
        cold_verify = round(time.time() - t0, 3)

    t0 = time.time()
    post, proof = GenerateWhiskShuffleProof(crs, pre, rng)
    prove_s = time.time() - t0

    t0 = time.time()
    ok = IsValidWhiskShuffleProof(crs, pre, post, proof)
    verify_s = time.time() - t0
    assert ok
    out = {"ell": ell, "prove_s": round(prove_s, 3), "verify_s": round(verify_s, 3)}
    if cold_prove is not None:
        out["cold_prove_s"] = cold_prove
        out["cold_verify_s"] = cold_verify
    return out


def bench_msm_sweep(sizes, methods):
    import hashlib

    import numpy as np

    from curdleproofs_jax.curve import G1
    from curdleproofs_jax.fields import FR_MOD, Fr
    from curdleproofs_jax.ops import g1 as og
    from curdleproofs_jax.ops import msm as omsm
    from curdleproofs_jax.ops.fieldspec import ints_to_limbs

    from curdleproofs_jax.curve import mul_host_batch

    out = []
    nmax = max(sizes)
    # random-dlog bases (protocol MSMs have unknown dlogs; incremental
    # multiples of G collide with the no-doubling fast-path scan and make
    # every stream run pay the doubling-safe redo). Build 2^16 natively
    # and tile beyond that — duplicate bases with fresh scalars keep the
    # doubling probability negligible while the host build stays minutes
    # shorter at 2^20.
    base_n = min(nmax, 1 << 16)
    dlogs = [
        Fr(
            int.from_bytes(
                hashlib.sha256(f"p{i}".encode()).digest()
                + hashlib.sha256(f"q{i}".encode()).digest(),
                "little",
            )
            % FR_MOD
        )
        for i in range(base_n)
    ]
    pts = mul_host_batch([G1()] * base_n, dlogs)
    while len(pts) < nmax:
        pts = pts + pts[: nmax - len(pts)]
    scs = [
        Fr(int.from_bytes(hashlib.sha256(f"s{i}".encode()).digest(), "little") % FR_MOD)
        for i in range(nmax)
    ]
    ints = [s.v for s in scs]
    for n in sizes:
        points = og.pack_points(pts[:n])
        scalars = og.pack_scalars(scs[:n])
        sc_np = np.asarray(ints_to_limbs(ints[:n], 16), dtype=np.uint32)
        c = omsm.pick_window(n)
        W = -(-255 // c)
        canonical = W * (n + (1 << c))
        row = {"n": n, "c": c}
        for method in methods:

            def run():
                if method == "ladder":
                    p2, s2 = omsm._pad_pow2_inputs(points, scalars)
                    return omsm.msm_ladder(p2, s2)
                if method == "stream":
                    return omsm.msm_pippenger_stream(points, sc_np, c=c)
                return omsm.msm_pippenger(points, scalars)

            r0 = run()  # warmup/compile
            t0 = time.time()
            r1 = run()
            dt = time.time() - t0
            assert r0 == r1
            row[method] = {
                "wall_s": round(dt, 4),
                "canonical_ops_per_s": round(canonical / dt),
            }
        out.append(row)
        print("  msm", json.dumps(row), flush=True)
    return out


def bench_batch_verify(ell, n_blinders, k, seed):
    from curdleproofs_jax.curve import G1
    from curdleproofs_jax.models.crs import CurdleproofsCrs
    from curdleproofs_jax.models.shuffle import (
        CurdleProofsProof,
        VerifierInput,
        shuffle_permute_and_commit_input,
        verify_shuffle_proofs,
    )
    from curdleproofs_jax.utils.rng import ProofRng

    rng = ProofRng(seed)
    crs = CurdleproofsCrs.new(ell, n_blinders, rng)
    gen = G1()
    instances = []
    for _ in range(k):
        perm = rng.permutation(ell)
        key = rng.random_scalar()
        vec_R = [gen * rng.random_scalar() for _ in range(ell)]
        vec_S = [gen * rng.random_scalar() for _ in range(ell)]
        vec_T, vec_U, M, mb = shuffle_permute_and_commit_input(
            crs, vec_R, vec_S, perm, key, rng
        )
        proof = CurdleProofsProof.new(
            crs=crs, vec_R=vec_R, vec_S=vec_S, vec_T=vec_T, vec_U=vec_U, M=M,
            permutation=perm, k=key, vec_m_blinders=mb, rng=rng,
        )
        instances.append((proof, VerifierInput(vec_R, vec_S, vec_T, vec_U, M)))

    verify_shuffle_proofs(crs, instances)  # warmup (compiles)
    t0 = time.time()
    verify_shuffle_proofs(crs, instances)
    batch_s = time.time() - t0

    for proof, vi in instances[:1]:
        proof.verify(crs, vi.vec_R, vi.vec_S, vi.vec_T, vi.vec_U, vi.M)  # warm
    t0 = time.time()
    for proof, vi in instances:
        proof.verify(crs, vi.vec_R, vi.vec_S, vi.vec_T, vi.vec_U, vi.M)
    indiv_s = time.time() - t0
    return {
        "proofs": k,
        "batch_verify_s": round(batch_s, 3),
        "individual_verify_s": round(indiv_s, 3),
        "speedup": round(indiv_s / batch_s, 2),
    }


def bench_batch_prove(ell, n_blinders, k, seed):
    """Lockstep batch proving (GenerateWhiskShuffleProofs) vs K sequential
    proofs — SURVEY (2.3 batch parallelism on the PROVING side."""
    from curdleproofs_jax.models.crs import CurdleproofsCrs
    from curdleproofs_jax.models.whisk import (
        GenerateWhiskShuffleProof,
        GenerateWhiskShuffleProofs,
        IsValidWhiskShuffleProof,
    )
    from curdleproofs_jax.utils.rng import ProofRng

    rng = ProofRng(seed)
    crs = CurdleproofsCrs.new(ell, n_blinders, rng)
    pres = [build_trackers(ell, rng) for _ in range(k)]

    GenerateWhiskShuffleProofs(crs, pres[:2], rng)  # warm compiles
    t0 = time.time()
    results = GenerateWhiskShuffleProofs(crs, pres, rng)
    batch_s = time.time() - t0
    pre0, (post0, proof0) = pres[0], results[0]
    assert IsValidWhiskShuffleProof(crs, pre0, post0, proof0)

    t0 = time.time()
    for pre in pres:
        GenerateWhiskShuffleProof(crs, pre, rng)
    seq_s = time.time() - t0
    return {
        "proofs": k,
        "batch_prove_s": round(batch_s, 3),
        "sequential_prove_s": round(seq_s, 3),
        "speedup": round(seq_s / batch_s, 2),
    }


def bench_sharded_msm(n, seed):
    import hashlib

    import jax
    import numpy as np

    from curdleproofs_jax.curve import G1, mul_host_batch
    from curdleproofs_jax.fields import FR_MOD, Fr
    from curdleproofs_jax.ops import g1 as og
    from curdleproofs_jax.ops import msm as omsm
    from curdleproofs_jax.ops.fieldspec import ints_to_limbs
    from curdleproofs_jax.parallel.mesh import make_mesh
    from curdleproofs_jax.parallel.msm import (
        msm_sharded_ladder,
        msm_sharded_stream,
    )

    d = len(jax.devices())
    base_n = min(n, 1 << 16)
    dlogs = [
        Fr(
            int.from_bytes(
                hashlib.sha256(f"x{i}".encode()).digest()
                + hashlib.sha256(f"y{i}".encode()).digest(),
                "little",
            )
            % FR_MOD
        )
        for i in range(base_n)
    ]
    pts = mul_host_batch([G1()] * base_n, dlogs)
    while len(pts) < n:
        pts = pts + pts[: n - len(pts)]
    scs = [
        Fr(int.from_bytes(hashlib.sha256(f"h{i}".encode()).digest(), "little") % FR_MOD)
        for i in range(n)
    ]
    mesh = make_mesh(d)

    # the sharded stream engine (per-shard host sort, device scan, in-graph
    # collective window combine) vs the unsharded engine on identical inputs
    rs0 = msm_sharded_stream(pts, scs, mesh=mesh)  # warmup
    t0 = time.time()
    rs1 = msm_sharded_stream(pts, scs, mesh=mesh)
    dts = time.time() - t0
    assert rs1 == rs0

    # symmetric comparison: the sharded call packs host points inside, so
    # the unsharded side is timed packing included as well
    def unsharded():
        points = og.pack_points(pts)
        sc_np = np.asarray(
            ints_to_limbs([s.v for s in scs], 16), dtype=np.uint32
        )
        return omsm.msm_pippenger_stream(points, sc_np)

    r0 = unsharded()  # warmup
    assert r0 == rs0
    t0 = time.time()
    unsharded()
    dtu = time.time() - t0

    out = {
        "n": n,
        "devices": d,
        "method": "sharded_stream",
        "wall_s": round(dts, 4),
        "unsharded_wall_s": round(dtu, 4),
        "sharding_overhead": round(dts / dtu, 3),
    }

    # ladder variant (secondary engine) for cross-check
    rl0 = msm_sharded_ladder(pts, scs, mesh=mesh)
    assert rl0 == rs0
    t0 = time.time()
    msm_sharded_ladder(pts, scs, mesh=mesh)
    out["ladder_wall_s"] = round(time.time() - t0, 4)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()

    report = {}
    t_all = time.time()

    report["config1_ell60_shuffle"] = bench_shuffle(60, 4, seed=1)
    print("config1", json.dumps(report["config1_ell60_shuffle"]))

    sizes = (
        [1 << 12, 1 << 14]
        if args.quick
        else [1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 20]
    )
    report["config2_msm_sweep"] = bench_msm_sweep(
        sizes, methods=("ladder", "stream")
    )
    print("config2", json.dumps(report["config2_msm_sweep"]))

    report["config3_ell124_whisk"] = bench_shuffle(124, 4, seed=2)
    print("config3", json.dumps(report["config3_ell124_whisk"]))

    k = 4 if args.quick else 64
    report["config4_batch_verify"] = bench_batch_verify(60, 4, k, seed=3)
    print("config4", json.dumps(report["config4_batch_verify"]))

    report["config5_sharded_msm"] = bench_sharded_msm(
        1 << 14 if args.quick else 1 << 20, seed=4
    )
    print("config5", json.dumps(report["config5_sharded_msm"]))

    report["config6_batch_prove"] = bench_batch_prove(
        124, 4, 4 if args.quick else 16, seed=5
    )
    print("config6", json.dumps(report["config6_batch_prove"]))

    report["total_s"] = round(time.time() - t_all, 1)
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print("report ->", out)


if __name__ == "__main__":
    main()
