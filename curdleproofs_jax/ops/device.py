"""The one decision of where batched group work runs.

Every engine choice that depends on the machine (MSM dispatch, lockstep
merging, batched decompression, the sharded ladder, the limb-loop form of
the field arithmetic) asks `on_accelerator()`. It reads the default backend
at call time, so a process pinned to the CPU (the test suite) keeps the host
paths and a process on a GPU takes the device ones.
"""
from __future__ import annotations

import os

import jax

# XLA compiles a GPU program's kernels on one thread unless this is on; the
# group-arithmetic programs hold hundreds of kernels each.
GPU_COMPILE_FLAGS = ("--xla_gpu_enable_llvm_module_compilation_parallelism=true",)


def on_accelerator() -> bool:
    """True when JAX's default backend is a GPU."""
    return jax.default_backend() == "gpu"


def set_gpu_compile_flags() -> None:
    """Add GPU_COMPILE_FLAGS to XLA_FLAGS (a flag already named there wins).
    XLA reads them when JAX first creates a backend, so launchers call this
    before their first device query."""
    flags = os.environ.get("XLA_FLAGS", "")
    for f in GPU_COMPILE_FLAGS:
        if f.split("=")[0] not in flags:
            flags = f"{flags} {f}".strip()
    os.environ["XLA_FLAGS"] = flags
