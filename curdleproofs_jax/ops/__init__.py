"""Device compute kernels (field limb arithmetic, G1 group ops, MSM).

Importing this package turns on JAX's persistent compilation cache so the
large jitted field/point graphs compile once per machine. Where
JAX_COMPILATION_CACHE_DIR is set, JAX uses that directory and nothing here
overrides it; otherwise the cache lives at the fixed <checkout>/.jax_cache.
"""
import os

import jax

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The compilation cache directory this process uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
