"""Framework configuration knobs (environment variables).

Protocol constants (N_BLINDERS, curve order, STROBE rate, transcript labels)
are FROZEN — they define wire compatibility with the reference. Everything
here only tunes execution.

  JAX_COMPILATION_CACHE_DIR  persistent compilation cache directory
                             (default <checkout>/.jax_cache).
  CURDLEPROOFS_BATCH_PROVE   "thread" (default) or "lockstep" batch proving
                             (protocol.whisk.GenerateWhiskShuffleProofs).
  BENCH_N / BENCH_C / BENCH_REPS / BENCH_METHOD
                             bench.py inputs (see bench.py docstring).

The device decision (ops.device.on_accelerator) and the limb-loop form
(ops.modarith.limb_mode) follow the backend JAX runs on.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RuntimeConfig:
    accelerator: bool
    limb_mode: str
    cache_dir: str


def current() -> RuntimeConfig:
    from curdleproofs_jax.ops import cache_dir
    from curdleproofs_jax.ops.device import on_accelerator
    from curdleproofs_jax.ops.modarith import limb_mode

    return RuntimeConfig(
        accelerator=on_accelerator(),
        limb_mode=limb_mode(),
        cache_dir=cache_dir(),
    )
