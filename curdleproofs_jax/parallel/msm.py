"""Multi-device / multi-host sharded MSM.

msm_sharded: points and digits are sharded across the mesh's point axis;
every device runs the full local sort + prefix-scan + boundary-gather
Pippenger pipeline on its shard (ops.msm._window_partials), producing
per-shard window partials, which an `all_gather` inside the same jitted
shard_map collects over the interconnect (NVLink within a host). They are
combined by linearity on the host:

    S_w = sum_shards [ (B-1) * total_shard  -  bsum_{shard, w} ]

— D*(W+1) host group ops plus the 255-op Horner window combine, kept off
the device so each sharded program holds only its engine's own point ops
(compile time). msm_sharded_ladder reduces its one point per shard
in-graph (gather + tree reduce); msm_sharded_stream runs slices of the
one-device stream engine on the mesh's devices. This is the distributed
backend the
reference lacks (SURVEY.md §2.3, §5: "bucket-sum all-reduce").

This module is exercised on a virtual 8-device CPU mesh in tests and by
__graft_entry__.dryrun_multichip; on a multi-GPU host the same code runs
over a 1-D mesh of the cards.
"""
from __future__ import annotations

import functools
import time
from functools import partial
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from curdleproofs_jax.curve import G1
from curdleproofs_jax.fields import Fr
from curdleproofs_jax.ops import g1 as og
from curdleproofs_jax.ops import msm as omsm
from curdleproofs_jax.ops import scan as oscan
from curdleproofs_jax.ops.g1 import APoints, JPoints
from curdleproofs_jax.parallel.mesh import make_mesh

FR_BITS = omsm.FR_BITS


def _allreduce_group(p: JPoints, axis: str) -> JPoints:
    """Group-element all-reduce over a mesh axis: all_gather the Jacobian
    limbs, then tree-reduce the gathered axis with exact group adds on every
    device (replicated result). psum would be a plain integer add — wrong
    for curve points — so gather+local-reduce IS the collective."""
    gx = jax.lax.all_gather(p.x, axis)  # (D, 24, ...)
    gy = jax.lax.all_gather(p.y, axis)
    gz = jax.lax.all_gather(p.z, axis)
    g = JPoints(
        jnp.moveaxis(gx, 0, -1), jnp.moveaxis(gy, 0, -1), jnp.moveaxis(gz, 0, -1)
    )
    return oscan.tree_reduce_hybrid(g)


def _gather_partials(total: JPoints, bsums: JPoints, axis: str):
    """All-gather every shard's (total (24,), bucket-weighted boundary sums
    (24, wb)) over the mesh axis: the collective is a plain limb gather;
    the group arithmetic that combines the D partials runs on the host
    (_combine_partials_host), which keeps the sharded program to the
    per-shard engine's own point ops."""
    return tuple(
        jax.lax.all_gather(a, axis)
        for a in (total.x, total.y, total.z, bsums.x, bsums.y, bsums.z)
    )


def _combine_partials_host(outs):
    """Gathered (D, 24) totals and (D, 24, wb) bucket sums -> host
    (sum of shard totals, [sum over shards of bsum_w for w < wb]), the
    inputs of ops.msm._combine_windows_host (MSM linearity:
    S_w = sum_s ((B-1) total_s - bsum_{s,w}))."""
    import numpy as np

    tx, ty, tz, bx, by, bz = (np.asarray(o) for o in outs)
    D, _, wb = bx.shape
    tots = og.jpoints_to_host(JPoints(tx.T, ty.T, tz.T))

    def flat(a):  # (D, 24, wb) -> (24, D*wb), lane s*wb + w
        return a.transpose(1, 0, 2).reshape(24, D * wb)

    bs = og.jpoints_to_host(JPoints(flat(bx), flat(by), flat(bz)))
    total = G1.identity()
    for t in tots:
        total = total + t
    sums = []
    for w in range(wb):
        acc = G1.identity()
        for s in range(D):
            acc = acc + bs[s * wb + w]
        sums.append(acc)
    return total, sums


def _shard_kernel(points: APoints, digits: jnp.ndarray, c: int, axis: str):
    """Per-shard window partials, all-gathered over the mesh."""
    total, bsums = omsm._window_partials(points, digits, c)
    return _gather_partials(total, bsums, axis)


@functools.lru_cache(maxsize=None)
def _pippenger_shard_fn(mesh: Mesh, point_axis: str, c: int):
    """Jitted shard_map window-partials kernel, cached per (mesh, axis, c)."""
    pspec = APoints(P(None, point_axis), P(None, point_axis), P(point_axis))
    dspec = P(None, point_axis)
    out_spec = (P(),) * 6
    return jax.jit(
        shard_map(
            partial(_shard_kernel, c=c, axis=point_axis),
            mesh=mesh,
            in_specs=(pspec, dspec),
            out_specs=out_spec,
            check_vma=False,  # all_gather replicates; vma tracking off
        )
    )


@functools.lru_cache(maxsize=None)
def _ladder_shard_fn(mesh: Mesh, point_axis: str):
    """Jitted shard_map GLV ladder kernel, cached per (mesh, axis) —
    rebuilding the closure per call would recompile on every invocation."""

    def kernel(px, py, pinf, ng, sa, sb):
        acc = og.scalar_mul_glv(APoints(px, py, pinf), sa, ng, sb)
        r = oscan.tree_reduce_hybrid(acc)
        g = _allreduce_group(
            JPoints(r.x[:, None], r.y[:, None], r.z[:, None]), point_axis
        )  # (24, 1) replicated: the ONE Jacobian point crossing devices
        return g.x[:, 0], g.y[:, 0], g.z[:, 0]

    return jax.jit(
        shard_map(
            kernel,
            mesh=mesh,
            in_specs=(
                P(None, point_axis),
                P(None, point_axis),
                P(point_axis),
                P(point_axis),
                P(None, point_axis),
                P(None, point_axis),
            ),
            out_specs=(P(None), P(None), P(None)),
            check_vma=False,
        )
    )


def msm_sharded_ladder(
    bases: Sequence[G1],
    scalars: Sequence[Fr],
    mesh: Optional[Mesh] = None,
    point_axis: str = "shard",
) -> G1:
    """Point-sharded ladder MSM.

    Each shard runs the GLV dual-table ladder (og.scalar_mul_glv, scalars
    split on the host) + tree reduce on its local points; exactly ONE
    Jacobian point (288 B) per shard crosses the interconnect. Results are
    bit-identical for any mesh shape (exact adds).
    """
    import numpy as np

    from curdleproofs_jax.ops import glv
    from curdleproofs_jax.ops.fieldspec import ints_to_limbs

    if len(bases) != len(scalars):
        raise ValueError("msm length mismatch")
    if not bases:
        return G1.identity()
    mesh = mesh or make_mesh()
    D = mesh.shape[point_axis]

    # identical power-of-two local width per shard, >= 128 lanes
    n = len(bases)
    local = 128
    while local * D < n:
        local *= 2
    m = local * D
    points = og.pack_points(list(bases) + [G1.identity()] * (m - n))
    ints = [s.v for s in scalars] + [0] * (m - n)
    sc16 = np.asarray(ints_to_limbs(ints, 16), dtype=np.uint32)
    s1, neg1, s2 = glv.decompose(sc16.astype(np.uint64))
    rx, ry, rz = _ladder_shard_fn(mesh, point_axis)(
        points.x,
        points.y,
        points.inf,
        jnp.asarray(neg1),
        jnp.asarray(s1),
        jnp.asarray(s2),
    )
    # combined in-graph (all_gather + tree reduce); one replicated point out
    return og.jpoints_to_host(JPoints(rx[:, None], ry[:, None], rz[:, None]))[0]


def msm_sharded_stream(
    bases: Sequence[G1],
    scalars: Sequence[Fr],
    mesh: Optional[Mesh] = None,
    c: Optional[int] = None,
) -> G1:
    """Point-sharded STREAMING Pippenger over the devices of a mesh.

    The n pairs are cut into slices of at most STREAM_SPLIT (and at most
    n / D, so every device gets work); slice k runs the single-device stream
    engine (ops.msm._msm_stream_impl: host digit sort, device scan, the
    doubling-flag redo) with all of its inputs placed on device k mod D, one
    host thread per device so the devices work at once, and the slice
    results add on the host (MSM linearity). Each device runs the SAME
    program as a one-device stream MSM of the slice size. Cross-device
    traffic: one point per slice, to the host. Each slice is tagged
    `msm.shard.<id>` in utils.profiling with the id of the device its result
    array was on, and a slice that ran anywhere but its device raises."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor

    from curdleproofs_jax.ops.fieldspec import ints_to_limbs
    from curdleproofs_jax.utils import profiling

    if len(bases) != len(scalars):
        raise ValueError("msm length mismatch")
    if not bases:
        return G1.identity()
    mesh = mesh or make_mesh()
    devices = list(mesh.devices.flat)
    D = len(devices)
    n = len(bases)
    sz = min(omsm.STREAM_SPLIT, -(-n // D))
    points = og.pack_points(list(bases))
    host = [np.asarray(a) for a in points]
    sc_np = np.asarray(ints_to_limbs([s.v for s in scalars], 16), dtype=np.uint32)
    starts = list(range(0, n, sz))

    def run_device(d: int) -> G1:
        dev = devices[d]
        acc = G1.identity()
        for o in starts[d::D]:
            sub = APoints(*(a[..., o : o + sz] for a in host))
            k = sub.x.shape[-1]
            cs = c or omsm.pick_window(max(k, 32))
            t0 = time.perf_counter()
            r, ran_on = omsm._msm_stream_impl(
                sub, sc_np[:, o : o + sz], cs, device=dev
            )
            if ran_on != dev:
                raise RuntimeError(f"slice for {dev} ran on {ran_on}")
            profiling.metrics().record(
                f"msm.shard.{ran_on.id}", time.perf_counter() - t0, k
            )
            acc = acc + r
        return acc

    total = G1.identity()
    with ThreadPoolExecutor(max_workers=D) as pool:
        for r in pool.map(run_device, range(D)):
            total = total + r
    return total


def msm_sharded(
    bases: Sequence[G1],
    scalars: Sequence[Fr],
    mesh: Optional[Mesh] = None,
    c: Optional[int] = None,
    window_batch: Optional[int] = None,
    point_axis: str = "shard",
) -> G1:
    """MSM with the point dimension sharded across a device mesh."""
    if len(bases) != len(scalars):
        raise ValueError("msm length mismatch")
    if not bases:
        return G1.identity()
    mesh = mesh or make_mesh()
    D = mesh.shape[point_axis]

    # pad so each shard gets an identical power-of-two local width >= 32
    n = len(bases)
    local = 32
    while local * D < n:
        local *= 2
    m = local * D
    pts_host = list(bases) + [G1.identity()] * (m - n)
    scs_host = list(scalars) + [Fr(0)] * (m - n)
    points = og.pack_points(pts_host)
    scalars_l = og.pack_scalars(scs_host)

    c = c or omsm.pick_window(local)
    W = -(-FR_BITS // c)
    if window_batch is None:
        # at most 2^19 scan lanes per chunk: a vec-form field multiply
        # (ops.modarith) can hold ~12 KB of limb products per lane
        window_batch = max(1, min(W, (1 << 19) // max(local, 1)))
    digits = omsm.extract_digits(scalars_l, c)

    kernel = _pippenger_shard_fn(mesh, point_axis, c)

    sums: List[G1] = []  # per-window bucket sums, summed over shards
    for w0 in range(0, W, window_batch):
        chunk = digits[w0 : w0 + window_batch]
        if chunk.shape[0] != window_batch:
            pad = jnp.zeros((window_batch - chunk.shape[0], m), dtype=chunk.dtype)
            chunk = jnp.concatenate([chunk, pad], axis=0)
        total, part = _combine_partials_host(kernel(points, chunk))
        sums.extend(part)
    return omsm._combine_windows_host(total, sums[:W], c, W)
