"""Test configuration.

Tests run on the CPU with a virtual 8-device mesh so sharding/collective
code paths compile and execute without accelerator hardware. The on-card
subset (tests/test_gpu_hw.py, marker `gpu`) runs on the GPU when
CURDLEPROOFS_TEST_GPU=1 is set:

    CURDLEPROOFS_TEST_GPU=1 python -m pytest tests/test_gpu_hw.py -m gpu

The native host extensions are built once per session (on the xdist
controller, before any worker imports the package); a failed build only
leaves the pure-Python fallbacks in place.
"""
import os
import sys
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not os.environ.get("CURDLEPROOFS_TEST_GPU"):
    jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # xdist worker: the controller built
        return
    from build_native import ensure_native

    try:
        ensure_native()
    except Exception as e:  # never fail the session over a missing compiler
        warnings.warn(f"native extensions not built: {e}")
