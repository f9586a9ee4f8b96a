"""Multi-host (multi-process) execution helpers.

A multi-host MSM is the single-host sharded MSM over a global mesh: each host
runs this same program, `jax.distributed` wires the processes together, and
`make_mesh()` over `jax.devices()` (global device list) spans hosts. Points
shard across the global point axis; each chip computes local window partials
and only the per-shard partial sums (a few KB) cross DCN — see
parallel/msm.py.

Usage per host:

    from curdleproofs_jax.parallel import distributed, make_mesh, msm_sharded
    distributed.initialize(coordinator_address="host0:1234",
                           num_processes=N, process_id=i)
    mesh = make_mesh()                      # global mesh across all hosts
    result = msm_sharded(bases, scalars, mesh=mesh)

This module is exercised in single-process form by tests (virtual devices);
real multi-host validation requires a pod slice.
"""
from __future__ import annotations

from typing import Optional


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed (no-op when already initialized or when
    running single-process with all arguments None)."""
    import jax

    if num_processes in (None, 1) and coordinator_address is None:
        return  # single-process: nothing to do
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_multiprocess() -> bool:
    import jax

    return jax.process_count() > 1
