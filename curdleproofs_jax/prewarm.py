"""Compile-cache prewarm: `python -m curdleproofs_jax.prewarm`.

Compiling the stream-MSM pipeline and the ladder takes a long time per
shape on a fresh environment; the shapes are keyed only by (n, window bits,
chunk schedule), so one pass here populates the persistent JAX compilation
cache (ops.cache_dir()) and every later bench / production call starts
warm.

Shapes warmed (env-tunable):
  * streaming Pippenger at n = 2^16 (PREWARM_N16=0 skips) and n = 2^20
    (PREWARM_N20=0 skips), default window bits + uneven chunk schedule
  * the GLV ladder at protocol width (128 lanes)
  * the device batch-decompression sqrt chain at DECOMPRESS_DEVICE_MIN
"""
from __future__ import annotations

import os
import time


def _log(msg: str) -> None:
    print(f"[prewarm +{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


_T0 = time.perf_counter()


def prewarm() -> None:
    import numpy as np

    from curdleproofs_jax.curve import (
        DECOMPRESS_DEVICE_MIN,
        G1,
        compress_host_batch,
        decompress_host_batch,
    )
    from curdleproofs_jax.fields import Fr
    from curdleproofs_jax.ops import g1 as og
    from curdleproofs_jax.ops import msm as omsm
    from curdleproofs_jax.ops.fieldspec import ints_to_limbs

    sizes = []
    if os.environ.get("PREWARM_N16", "1") == "1":
        sizes.append(1 << 16)
    if os.environ.get("PREWARM_N20", "1") == "1":
        sizes.append(1 << 20)

    # a handful of distinct real points tiled to width (compile cares about
    # shapes, not values, but the correctness-checkable values are free)
    base = [G1() * Fr(i + 1) for i in range(64)]
    for n in sizes:
        reps = n // len(base)
        b64 = og.pack_points(base)
        import jax.numpy as jnp

        pts = og.APoints(
            jnp.asarray(np.tile(np.asarray(b64.x), (1, reps))),
            jnp.asarray(np.tile(np.asarray(b64.y), (1, reps))),
            jnp.asarray(np.tile(np.asarray(b64.inf), reps)),
        )
        scs = np.asarray(
            ints_to_limbs([(7 * i + 3) % 65521 for i in range(n)], 16),
            dtype=np.uint32,
        )
        t0 = time.perf_counter()
        omsm.msm_pippenger_stream(pts, scs)
        _log(f"stream n=2^{n.bit_length() - 1}: {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    omsm.msm(base * 2, [Fr(i + 1) for i in range(128)], method="ladder")
    _log(f"ladder 128: {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    blob = compress_host_batch(base) * (DECOMPRESS_DEVICE_MIN // 64)
    decompress_host_batch(blob)
    _log(f"decompress {DECOMPRESS_DEVICE_MIN}: {time.perf_counter() - t0:.1f}s")
    _log("done")


if __name__ == "__main__":
    prewarm()
