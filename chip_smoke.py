#!/usr/bin/env python
"""Smoke test of the main path on one GPU, in one process.

    python chip_smoke.py               # phases 0-5 on one card
    python chip_smoke.py --four-cards  # only the 4-card sharded MSM phase:
                                       # msm_sharded_stream and msm_sharded
                                       # at 2^20 over 4 cards vs one card
                                       # vs msm_host

Phases (each prints one line: result, compile seconds, run seconds and the
engines that ran, read from utils.profiling tags):
  0. environment: JAX, devices, compile cache, native extensions, the card;
     stops unless JAX's first device is a GPU;
  1. G1 MSM at n = 2^16 and 2^20 with random-discrete-log bases, through
     ops.msm.msm(method="auto") and msm_pippenger_stream, equal to the
     native host Pippenger (curve.msm_host);
  2. one Whisk shuffle proof at the spec size (ell = 124, 4 blinders) and a
     tracker opening proof: valid proofs verify, a flipped byte does not;
  3. lockstep batch proving of K = 32 shuffles (merged width 4096);
  4. catch-up sync: AreValidWhiskShuffleProofs over those 32 proofs, and
     with one proof tampered;
  5. the on-card test subset tests/test_gpu_hw.py, in this process.

All device arithmetic is exact integer math, so every comparison is exact
equality. The last line is {"ok": true, "device": {...}}; any failed phase
exits non-zero before it.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

K_PROVERS = 32


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


_compile_s = [0.0]


def _on_duration(event, duration, **_):
    if event.startswith("/jax/core/compile/"):
        _compile_s[0] += duration


def phase(name, fn):
    """Run one phase; print its line; re-raise on failure."""
    from curdleproofs_jax.utils import profiling

    with profiling.collect() as reg:
        c0 = _compile_s[0]
        t0 = time.perf_counter()
        try:
            result = fn()
        except Exception as e:
            print(f"phase {name}: FAILED {type(e).__name__}: {e}", flush=True)
            raise
        wall = time.perf_counter() - t0
        comp = _compile_s[0] - c0
        engines = {
            k: f"{v['calls']}x n={v['total_items']}" for k, v in reg.report().items()
        }
    print(
        f"phase {name}: {result} | compile_s={comp:.1f} run_s={wall - comp:.1f}"
        f" | engines={json.dumps(engines)}",
        flush=True,
    )
    return engines


def random_dlog_inputs(n, tag):
    """n bases with random discrete logs and n random scalars, derived from
    sha512 of a tag. Bases are B_j + C_k over two sets of ~sqrt(n) random
    multiples of G (native batch mul), summed in affine coordinates with one
    shared inversion (Montgomery's trick), so 2^20 bases cost ~2^11 scalar
    muls and no per-point inversion."""
    from curdleproofs_jax.curve import G1, mul_host_batch
    from curdleproofs_jax.fields import FQ_MOD, FR_MOD, Fr

    def h(s):
        return int.from_bytes(hashlib.sha512(s.encode()).digest(), "little") % FR_MOD

    a = 1 << ((n.bit_length() - 1) // 2)
    b = -(-n // a)
    rows = mul_host_batch([G1()] * a, [Fr(h(f"{tag}b{j}")) for j in range(a)])
    cols = mul_host_batch([G1()] * b, [Fr(h(f"{tag}c{k}")) for k in range(b)])
    ps = [rows[i % a] for i in range(n)]
    qs = [cols[i // a] for i in range(n)]
    dx = [(q.x - p.x) % FQ_MOD for p, q in zip(ps, qs)]
    pref, acc = [0] * n, 1
    for i, d in enumerate(dx):
        check(d != 0, "equal x in base generation")
        pref[i] = acc
        acc = acc * d % FQ_MOD
    inv = pow(acc, -1, FQ_MOD)
    pts = [None] * n
    for i in range(n - 1, -1, -1):
        di = inv * pref[i] % FQ_MOD  # 1 / dx[i]
        inv = inv * dx[i] % FQ_MOD
        p, q = ps[i], qs[i]
        lam = (q.y - p.y) * di % FQ_MOD
        x3 = (lam * lam - p.x - q.x) % FQ_MOD
        pts[i] = G1(x3, lam * (p.x - x3) - p.y)
    scs = [Fr(h(f"{tag}s{i}")) for i in range(n)]
    return pts, scs


def limbs(scs):
    import numpy as np

    from curdleproofs_jax.ops.fieldspec import ints_to_limbs

    return np.asarray(ints_to_limbs([s.v for s in scs], 16), dtype=np.uint32)


def phase_msm(n):
    from curdleproofs_jax.curve import msm_host
    from curdleproofs_jax.ops import g1 as og
    from curdleproofs_jax.ops import msm as omsm
    from curdleproofs_jax.utils import profiling

    pts, scs = random_dlog_inputs(n, f"msm{n}")
    want = msm_host(pts, scs)
    got_auto = omsm.msm(pts, scs, method="auto")
    check(got_auto == want, f"msm(auto) at n={n} differs from msm_host")
    check(
        "msm.stream" in profiling.metrics_report(),
        f"msm(auto) at n={n} did not use the device stream engine",
    )
    packed, sc = og.pack_points(pts), limbs(scs)
    got = omsm.msm_pippenger_stream(packed, sc)
    check(got == want, f"msm_pippenger_stream at n={n} differs from msm_host")
    t0 = time.perf_counter()
    omsm.msm_pippenger_stream(packed, sc)
    warm = time.perf_counter() - t0
    return f"n={n} auto == stream == msm_host; warm stream call {warm:.3f} s"


def whisk_trackers(n, rng):
    from curdleproofs_jax.curve import G1
    from curdleproofs_jax.models.whisk import BLSPubkey, WhiskTracker

    out = []
    for _ in range(n):
        r_G = G1() * rng.random_scalar()
        out.append(
            WhiskTracker(
                BLSPubkey(r_G.to_compressed_bytes()),
                BLSPubkey((r_G * rng.random_scalar()).to_compressed_bytes()),
            )
        )
    return out


def phase_whisk(crs, rng):
    from curdleproofs_jax.curve import G1
    from curdleproofs_jax.models.whisk import (
        BLSPubkey,
        GenerateWhiskShuffleProof,
        GenerateWhiskTrackerProof,
        IsValidWhiskOpeningProof,
        IsValidWhiskShuffleProof,
        WhiskTracker,
    )

    pre = whisk_trackers(crs.ell, rng)
    post, proof = GenerateWhiskShuffleProof(crs, pre, rng)
    check(IsValidWhiskShuffleProof(crs, pre, post, proof), "valid proof rejected")
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    check(
        not IsValidWhiskShuffleProof(crs, pre, post, bytes(bad)),
        "proof with a flipped byte accepted",
    )
    k = rng.random_scalar()
    r_G = G1() * rng.random_scalar()
    tracker = WhiskTracker(
        BLSPubkey(r_G.to_compressed_bytes()),
        BLSPubkey((r_G * k).to_compressed_bytes()),
    )
    tproof = GenerateWhiskTrackerProof(tracker, k, rng)
    k_commit = BLSPubkey((G1() * k).to_compressed_bytes())
    check(
        IsValidWhiskOpeningProof(tracker, k_commit, tproof),
        "valid opening proof rejected",
    )
    return f"ell={crs.ell} shuffle proof {len(proof)} B verifies, flipped byte rejected; opening proof verifies"


def phase_lockstep(crs, rng, out):
    from curdleproofs_jax.models.whisk import (
        GenerateWhiskShuffleProofs,
        IsValidWhiskShuffleProof,
    )

    pres = [whisk_trackers(crs.ell, rng) for _ in range(K_PROVERS)]
    os.environ["CURDLEPROOFS_BATCH_PROVE"] = "lockstep"
    try:
        res = GenerateWhiskShuffleProofs(crs, pres, rng)
    finally:
        del os.environ["CURDLEPROOFS_BATCH_PROVE"]
    for pre, (post, proof) in zip(pres, res):
        check(IsValidWhiskShuffleProof(crs, pre, post, proof), "lockstep proof rejected")
        out.append((pre, post, proof))
    return f"K={K_PROVERS} lockstep proofs all verify"


def phase_sync(crs, instances):
    from curdleproofs_jax.models.whisk import AreValidWhiskShuffleProofs
    from curdleproofs_jax.utils import profiling

    check(AreValidWhiskShuffleProofs(crs, instances), "valid batch rejected")
    rep = profiling.metrics_report()
    width = {k: v["total_items"] for k, v in rep.items() if k.startswith("msm.")}
    dec = rep.get("decompress.device", {}).get("total_items", 0)
    bad = len(instances) // 2
    pre, post, proof = instances[bad]
    tampered = list(instances)
    tampered[bad] = (pre, post[1:] + post[:1], proof)
    check(not AreValidWhiskShuffleProofs(crs, tampered), "tampered batch accepted")
    check(
        dec >= len(instances) * 4 * crs.ell,
        f"device decompression did not run ({dec} points)",
    )
    check(
        any(k in width for k in ("msm.ladder", "msm.stream")),
        f"merged verification MSM did not run on the device: {width}",
    )
    return (
        f"K={len(instances)} batch verifies, tampered batch rejected;"
        f" device-decompressed {dec} points; merged MSM widths {width}"
    )


def phase_hw_tests():
    import pytest

    os.environ["CURDLEPROOFS_TEST_GPU"] = "1"

    class Count:
        passed = 0
        failed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.failed:
                self.failed += 1

    c = Count()
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:randomly",
         os.path.join(HERE, "tests", "test_gpu_hw.py")],
        plugins=[c],
    )
    check(rc == 0 and c.failed == 0 and c.passed >= 6,
          f"tests/test_gpu_hw.py: rc={rc} passed={c.passed} failed={c.failed}")
    return f"tests/test_gpu_hw.py: {c.passed} passed"


def phase_four_cards(n=1 << 20):
    """The sharded MSMs over a 1-D mesh of the first four devices vs the
    one-card stream engine and the host oracle: msm_sharded_stream (slices
    of the stream engine, one per device at a time) and msm_sharded
    (shard_map over the mesh, partials all-gathered). msm_sharded runs in a
    second thread from the start, so its compilation overlaps the stream
    engine's."""
    from concurrent.futures import ThreadPoolExecutor

    import jax

    from curdleproofs_jax.curve import msm_host
    from curdleproofs_jax.ops import g1 as og
    from curdleproofs_jax.ops import msm as omsm
    from curdleproofs_jax.parallel.mesh import make_mesh
    from curdleproofs_jax.parallel.msm import msm_sharded, msm_sharded_stream
    from curdleproofs_jax.utils import profiling

    check(len(jax.devices()) >= 4, f"need 4 devices, have {len(jax.devices())}")
    mesh = make_mesh(4)
    mesh_ids = sorted(d.id for d in mesh.devices.flat)
    pts, scs = random_dlog_inputs(n, "sharded")
    want = msm_host(pts, scs)

    def timed_call(fn):
        t0 = time.perf_counter()
        r = fn()
        return r, time.perf_counter() - t0

    pool = ThreadPoolExecutor(max_workers=1)
    sharded = pool.submit(timed_call, lambda: msm_sharded(pts, scs, mesh=mesh))
    pool.shutdown(wait=False)
    single, t_one = timed_call(
        lambda: omsm.msm_pippenger_stream(og.pack_points(pts), limbs(scs))
    )
    check(single == want, "one-card stream differs from msm_host")
    profiling.metrics().reset()
    got_s, t_s = timed_call(lambda: msm_sharded_stream(pts, scs, mesh=mesh))
    rep = profiling.metrics_report()
    ran = {int(k.rsplit(".", 1)[1]): v["calls"] for k, v in rep.items()
           if k.startswith("msm.shard.")}
    print("msm_sharded_stream slices by the device their results were on: "
          + ", ".join(f"device {i}: {c}" for i, c in sorted(ran.items())),
          flush=True)
    check(got_s == want, "msm_sharded_stream differs from msm_host")
    check(sorted(ran) == mesh_ids, f"slices ran on devices {sorted(ran)}, mesh {mesh_ids}")
    got_w, t_w = sharded.result()
    print(f"msm_sharded over mesh devices {mesh_ids}", flush=True)
    check(got_w == want, "msm_sharded differs from msm_host")
    return (
        f"n={n} over {len(mesh_ids)} cards: msm_sharded_stream == msm_sharded =="
        f" one-card stream == msm_host; first-call s: one-card {t_one:.1f},"
        f" sharded_stream {t_s:.1f}, sharded {t_w:.1f}"
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded MSM phase")
    args = ap.parse_args()

    try:
        from build_native import ensure_native
    except ImportError:
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    built = ensure_native()  # raises with the compiler's error

    import jax

    from curdleproofs_jax.ops.device import set_gpu_compile_flags

    set_gpu_compile_flags()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX's first device is {dev.platform}", file=sys.stderr)
        return 2
    jax.monitoring.register_event_duration_secs_listener(_on_duration)

    from curdleproofs_jax.ops import cache_dir
    from curdleproofs_jax.ops.modarith import limb_mode

    import curdleproofs_jax._g1_native  # noqa: F401
    import curdleproofs_jax._keccak_native  # noqa: F401

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(f"jax {jax.__version__} devices={jax.devices()}")
    print(f"compile cache: {cache_dir()}  limb mode: {limb_mode()}")
    print(f"native extensions: _g1_native, _keccak_native (built now: {built or 'none'})")
    for line in smi.splitlines():
        print(line)
    sys.stdout.flush()

    try:
        if args.four_cards:
            phase("sharded-4", phase_four_cards)
        else:
            from curdleproofs_jax.models.crs import CurdleproofsCrs
            from curdleproofs_jax.utils.rng import ProofRng

            phase("msm-2^16", lambda: phase_msm(1 << 16))
            phase("msm-2^20", lambda: phase_msm(1 << 20))
            rng = ProofRng(7)
            crs = CurdleproofsCrs.new(124, 4, rng)
            phase("whisk", lambda: phase_whisk(crs, rng))
            instances = []
            eng = phase("lockstep", lambda: phase_lockstep(crs, rng, instances))
            check("msm.ladder_seg" in eng, f"lockstep never merged onto the device: {eng}")
            phase("sync", lambda: phase_sync(crs, instances))
            phase("gpu-tests", phase_hw_tests)
    except Exception:
        import traceback

        traceback.print_exc()
        return 1
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
