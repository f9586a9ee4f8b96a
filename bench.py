#!/usr/bin/env python
"""Headline benchmark: G1 MSM throughput on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", ...extras}.

The headline value is CANONICAL-MODEL point-ops/s at n=2^16: the useful
work of an MSM under the standard Pippenger cost model — W*(n + B) group
adds for W = ceil(255/c) windows of c bits, B = 2^c buckets, with c chosen
by ops.msm.pick_window(n) — divided by MEDIAN wall time over BENCH_REPS
runs (median + min/max spread reported). This counts the same work for
every engine, so an engine that executes MORE group ops than Pippenger
needs (e.g. the fixed-229-ops/lane GLV ladder) is not credited for the
redundancy. Executed-op throughput is reported as `executed_ops_per_s`.

A second measurement at n=2^20 (the BASELINE config-5 size, where fixed
costs amortize) rides in the same JSON line as `n20_*` fields
(BENCH_N20=0 skips it). Every line names the device it ran on; the script
fails when JAX finds no GPU.

Env knobs: BENCH_N (default 65536), BENCH_C (window bits), BENCH_REPS
(default 7), BENCH_METHOD (stream | ladder | hostsort | pippenger),
BENCH_WB (window chunk, or a comma-separated chunk schedule), BENCH_N20
(default 1).
"""
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from build_native import ensure_native  # noqa: E402


def build_inputs(n):
    """Deterministic inputs with RANDOM discrete logs (native batch scalar
    mul). Structured bases like incremental multiples of G are both
    unrepresentative of protocol MSMs (CRS/tracker points have unknown
    dlogs) and degenerate for the no-doubling fast-path scan: with tiny
    sequential dlogs, running prefixes collide with incoming bases and
    every rep pays the doubling-safe redo."""
    import hashlib

    from curdleproofs_jax.curve import G1, mul_host_batch
    from curdleproofs_jax.fields import FR_MOD, Fr

    dlogs = [
        Fr(
            int.from_bytes(
                hashlib.sha256(f"p{i}".encode()).digest()
                + hashlib.sha256(f"q{i}".encode()).digest(),
                "little",
            )
            % FR_MOD
        )
        for i in range(n)
    ]
    pts = mul_host_batch([G1()] * n, dlogs)
    scs = [
        Fr(
            int.from_bytes(
                hashlib.sha256(f"b{i}".encode()).digest(), "little"
            )
            % FR_MOD
        )
        for i in range(n)
    ]
    return pts, scs


def main():
    ensure_native()
    import jax
    import numpy as np

    from curdleproofs_jax.ops.device import set_gpu_compile_flags

    set_gpu_compile_flags()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX's first device is {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
    ).stdout.strip().splitlines()

    n = int(os.environ.get("BENCH_N", 1 << 16))
    reps = int(os.environ.get("BENCH_REPS", 7))

    from curdleproofs_jax.curve import G1, msm_host
    from curdleproofs_jax.fields import FR_MOD, Fr
    from curdleproofs_jax.ops import g1 as og
    from curdleproofs_jax.ops import msm as omsm
    from curdleproofs_jax.ops.fieldspec import ints_to_limbs

    import hashlib

    pts, scs = build_inputs(n)
    points = og.pack_points(pts)
    scalars = og.pack_scalars(scs)
    sc_np = np.asarray(ints_to_limbs([s.v for s in scs], 16), dtype=np.uint32)
    c = int(os.environ.get("BENCH_C", omsm.pick_window(n)))
    W = -(-255 // c)
    method = os.environ.get("BENCH_METHOD", "stream")
    wb = None
    if os.environ.get("BENCH_WB"):
        _w = os.environ["BENCH_WB"]
        wb = [int(x) for x in _w.split(",")] if "," in _w else int(_w)

    def run_with(pv, sv, sv_np, cc=c):
        if method == "ladder":
            return omsm.msm_ladder(pv, sv)
        if method == "stream":
            return omsm.msm_pippenger_stream(pv, sv_np, c=cc, window_batch=wb)
        if method == "hostsort":
            return omsm.msm_pippenger_hostsort(pv, sv_np, c=cc)
        return omsm.msm_pippenger(pv, sv, c=cc)

    def run():
        return run_with(points, scalars, sc_np)

    # warmup (compile; persistent cache makes this cheap on reruns)
    t0 = time.time()
    res0 = run()
    compile_s = time.time() - t0

    # correctness check against the exact host oracle, REUSING the compiled
    # full-width executable: first 128 scalars kept, the rest zeroed
    small = 128
    check_scs = scs[:small] + [Fr(0)] * (n - small)
    check_np = np.asarray(
        ints_to_limbs([s.v for s in check_scs], 16), dtype=np.uint32
    )
    got = run_with(points, og.pack_scalars(check_scs), check_np)
    assert got == msm_host(pts[:small], scs[:small]), "MSM check failed"

    times = []
    for _ in range(reps):
        t0 = time.time()
        res = run()
        times.append(time.time() - t0)
        assert res == res0, "nondeterministic MSM result"

    t = statistics.median(times)
    canonical_ops = W * (n + (1 << c))
    if method == "ladder":
        executed_ops = omsm.ladder_point_ops(n)
    elif method == "stream":
        executed_ops = omsm.stream_point_ops(n, c)
    elif method == "hostsort":
        executed_ops = omsm.hostsort_point_ops(n, c)
    else:
        executed_ops = W * (2 * n + 3 * (1 << c)) + 255
    value = canonical_ops / t

    # ---- n=2^20 (BASELINE config-5 size): bases tiled from the 2^16 set
    # (scalars fresh), canonical model at its own pick_window ------------
    n20 = {}
    if os.environ.get("BENCH_N20", "1") == "1" and method == "stream":
        n2 = 1 << 20
        tile = n2 // n
        px = np.tile(np.asarray(points.x), (1, tile))
        py = np.tile(np.asarray(points.y), (1, tile))
        pinf = np.tile(np.asarray(points.inf), tile)
        import jax.numpy as jnp

        points20 = og.APoints(jnp.asarray(px), jnp.asarray(py), jnp.asarray(pinf))
        scs20 = [
            int.from_bytes(hashlib.sha256(f"s{i}".encode()).digest(), "little")
            % FR_MOD
            for i in range(n2)
        ]
        sc20_np = np.asarray(ints_to_limbs(scs20, 16), dtype=np.uint32)
        c20 = int(os.environ.get("BENCH_C20", omsm.pick_window(n2)))
        t0 = time.time()
        r20 = omsm.msm_pippenger_stream(points20, sc20_np, c=c20)
        compile20 = time.time() - t0
        ts20 = []
        for _ in range(int(os.environ.get("BENCH_REPS20", 3))):
            t0 = time.time()
            r = omsm.msm_pippenger_stream(points20, sc20_np, c=c20)
            ts20.append(time.time() - t0)
            assert r == r20, "nondeterministic 2^20 MSM"
        W20 = -(-255 // c20)
        can20 = W20 * (n2 + (1 << c20))
        t20 = statistics.median(ts20)
        n20 = {
            "n20_ops_per_s": round(can20 / t20),
            "n20_wall_s": round(t20, 3),
            "n20_wall_min_s": round(min(ts20), 3),
            "n20_wall_max_s": round(max(ts20), 3),
            "n20_window_bits": c20,
            "n20_compile_s": round(compile20, 1),
        }

    # protocol-level latency extras (native host backend, ell=124 Whisk spec)
    from curdleproofs_jax.models.crs import CurdleproofsCrs
    from curdleproofs_jax.models.whisk import (
        BLSPubkey,
        GenerateWhiskShuffleProof,
        IsValidWhiskShuffleProof,
        WhiskTracker,
    )
    from curdleproofs_jax.utils.rng import ProofRng

    prng = ProofRng(1)
    crs = CurdleproofsCrs.new(124, 4, prng)
    gen = G1()
    pre = []
    for _ in range(124):
        r_s, k_s = prng.random_scalar(), prng.random_scalar()
        r_G = gen * r_s
        pre.append(
            WhiskTracker(
                BLSPubkey(r_G.to_compressed_bytes()),
                BLSPubkey((r_G * k_s).to_compressed_bytes()),
            )
        )
    post_w, wproof_w = GenerateWhiskShuffleProof(crs, pre, prng)  # warm
    assert IsValidWhiskShuffleProof(crs, pre, post_w, wproof_w)  # warm verify
    t0 = time.time()
    post, wproof = GenerateWhiskShuffleProof(crs, pre, prng)
    whisk_prove_s = time.time() - t0
    t0 = time.time()
    assert IsValidWhiskShuffleProof(crs, pre, post, wproof)
    whisk_verify_s = time.time() - t0
    out = {
        "metric": "g1_msm_point_ops_per_s_per_device",
        "value": round(value),
        "unit": "point-ops/s (canonical Pippenger model)",
        "n": n,
        "method": method,
        "window_bits": c,
        "windows": W,
        "canonical_ops": canonical_ops,
        "executed_ops": executed_ops,
        "executed_ops_per_s": round(executed_ops / t),
        "msm_wall_s": round(t, 4),
        "msm_wall_min_s": round(min(times), 4),
        "msm_wall_max_s": round(max(times), 4),
        "msm_per_s": round(1.0 / t, 3),
        "compile_s": round(compile_s, 1),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card[0] if card else None,
        "reps": reps,
        **n20,
        "whisk124_prove_s": round(whisk_prove_s, 3),
        "whisk124_verify_s": round(whisk_verify_s, 3),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
