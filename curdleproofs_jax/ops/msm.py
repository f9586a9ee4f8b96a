"""Multi-scalar multiplication engines (sort-based Pippenger, ladder).

Replaces the reference's naive serial loop (msm_accumulator.py:6-12) — the #1
performance gap called out in SURVEY.md §2 — with a dense, scatter-free
Pippenger variant built from batched, branchless group adds:

For each c-bit window w with digits d_i and buckets t in [0, 2^c):
    S_w = sum_i d_i * P_i = sum_t t * bucket_t
Sorting lanes by digit makes every bucket a contiguous segment, so with the
inclusive group-prefix-scan P (ops.scan) and boundary indices
e_t = (last sorted lane with digit <= t):
    S_w = (B-1) * total  -  sum_{t=0}^{B-2} P[e_t]
which needs only: one argsort + gather, ~2n batched group adds (scan), a
(B-1)-wide gather via searchsorted, and one tree-reduce. No scatter, no
data-dependent shapes, no bucket-occupancy assumptions — exact for any input
including repeated digits, zero scalars and infinity points.

Windows are vmapped in chunks (window_batch) to trade HBM footprint against
parallelism. The final window combination (Horner over 2^c) is O(255) single
point ops, done on host in exact arithmetic.
"""
from __future__ import annotations

import os
from functools import partial
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from curdleproofs_jax.curve import G1
from curdleproofs_jax.fields import Fr
from curdleproofs_jax.ops import g1 as og
from curdleproofs_jax.ops import gather as ogather
from curdleproofs_jax.ops import scan as oscan
from curdleproofs_jax.ops.device import on_accelerator
from curdleproofs_jax.ops.g1 import APoints, JPoints

FR_BITS = 255


def extract_digits(scalars: jnp.ndarray, c: int) -> jnp.ndarray:
    """(16, n) canonical Fr limbs -> (W, n) c-bit window digits (c <= 16)."""
    if not 1 <= c <= 16:
        raise ValueError("window size must be in [1, 16]")
    W = -(-FR_BITS // c)
    pad = jnp.zeros((2,) + scalars.shape[1:], dtype=scalars.dtype)
    s = jnp.concatenate([scalars, pad], axis=0)
    mask = jnp.uint32((1 << c) - 1)
    rows = []
    for w in range(W):
        b0 = w * c
        i0, off = divmod(b0, 16)
        v = s[i0] >> jnp.uint32(off)
        if off + c > 16:
            v = v | (s[i0 + 1] << jnp.uint32(16 - off))
        rows.append(v & mask)
    return jnp.stack(rows)


def _window_partials(points: APoints, digits: jnp.ndarray, c: int):
    """Per-window bucket-weighted sums for a chunk of windows.

    points: (24, n) affine; digits: (wb, n) -> returns (scan_total (24,),
    boundary_sums JPoints (24, wb)); caller assembles S_w on host.
    """
    B = 1 << c
    order = jnp.argsort(digits, axis=-1)  # (wb, n)
    sd = jnp.take_along_axis(digits, order, axis=-1)
    px = points.x[:, order]  # (24, wb, n)
    py = points.y[:, order]
    pinf = points.inf[order]
    jp = og.lift(APoints(px, py, pinf))
    P = oscan.inclusive_scan(jp)  # (24, wb, n) prefix sums

    ts = jnp.arange(B - 1, dtype=digits.dtype)  # buckets 0..B-2
    e = jax.vmap(lambda row: jnp.searchsorted(row, ts, side="right"))(sd) - 1
    mask = e >= 0  # (wb, B-1)
    eg = jnp.clip(e, 0, None)
    bx = jnp.take_along_axis(P.x, eg[None, :, :], axis=-1)
    by = jnp.take_along_axis(P.y, eg[None, :, :], axis=-1)
    bz = jnp.take_along_axis(P.z, eg[None, :, :], axis=-1)
    boundary = og.jselect(mask, JPoints(bx, by, bz), oscan.jinf(e.shape))
    bsums = oscan.tree_reduce_hybrid(boundary)  # (24, wb)
    total = JPoints(P.x[:, 0, -1], P.y[:, 0, -1], P.z[:, 0, -1])  # (24,)
    return total, bsums


@partial(jax.jit, static_argnames=("c",))
def _pippenger_device(points: APoints, digits: jnp.ndarray, c: int):
    return _window_partials(points, digits, c)


def _combine_windows_host(
    total: G1, bsums: List[G1], c: int, num_windows: int
) -> G1:
    """S = sum_w 2^{cw} * ((B-1)*total - bsums[w]), Horner, exact host math."""
    B = 1 << c
    big = total * Fr(B - 1)
    wins = [big - s for s in bsums]
    acc = G1.identity()
    for w in reversed(range(num_windows)):
        for _ in range(c):
            acc = acc + acc
        acc = acc + wins[w]
    return acc


def pick_window(n: int) -> int:
    """Window size balancing scan work (2n per window) vs bucket reduce.

    For the GLV-split stream engine W = ceil(130/c), so c = 13 (W = 10) does
    less per-window work than c = 12 (W = 11), and c = 15 (W = 9) pays off
    once n amortizes the 2^15-bucket boundary tables. Not yet re-measured on
    the GPU (ROADMAP.md)."""
    if n <= 32:
        return 4
    if n <= 1024:
        return 8
    if n <= 1 << 16:
        return 13
    return 15


def _pad_pow2_inputs(points: APoints, scalars: jnp.ndarray, min_width: int = 32):
    """Pad to a power of two (>= min_width) so kernels compile for a small,
    reusable set of shapes; identity bases / zero scalars are no-ops."""
    n = points.x.shape[-1]
    m = min_width
    while m < n:
        m *= 2
    if m == n:
        return points, scalars
    zpad = jnp.zeros((points.x.shape[0], m - n), dtype=points.x.dtype)
    spad = jnp.zeros((scalars.shape[0], m - n), dtype=scalars.dtype)
    return (
        APoints(
            jnp.concatenate([points.x, zpad], axis=-1),
            jnp.concatenate([points.y, zpad], axis=-1),
            jnp.concatenate([points.inf, jnp.ones(m - n, dtype=bool)], axis=-1),
        ),
        jnp.concatenate([scalars, spad], axis=-1),
    )


def msm_pippenger(
    points: APoints,
    scalars: jnp.ndarray,
    c: Optional[int] = None,
    window_batch: Optional[int] = None,
) -> G1:
    """Full MSM: points (24, n) affine, scalars (16, n) canonical -> host G1."""
    from curdleproofs_jax.utils.profiling import timed

    n_in = points.x.shape[-1]
    c_est = c or pick_window(max(n_in, 32))
    W_est = -(-FR_BITS // c_est)
    with timed(
        "msm.pippenger",
        items=n_in,
        point_ops=W_est * (2 * n_in + (1 << c_est)) + 255,
    ):
        return _msm_pippenger_impl(points, scalars, c, window_batch)


def _msm_pippenger_impl(
    points: APoints,
    scalars: jnp.ndarray,
    c: Optional[int] = None,
    window_batch: Optional[int] = None,
) -> G1:
    points, scalars = _pad_pow2_inputs(points, scalars)
    n = points.x.shape[-1]
    c = c or pick_window(n)
    W = -(-FR_BITS // c)
    if window_batch is None:
        # bound the (24, wb, n) x 3-coord x scan-level working set to ~2 GB
        window_batch = max(1, min(W, (1 << 21) // max(n, 1)))
    digits = extract_digits(scalars, c)
    total_host: Optional[G1] = None
    bsums_host: List[G1] = []
    for w0 in range(0, W, window_batch):
        chunk = digits[w0 : w0 + window_batch]
        if chunk.shape[0] != window_batch:  # keep a single compiled shape
            pad = jnp.zeros((window_batch - chunk.shape[0], n), dtype=chunk.dtype)
            chunk = jnp.concatenate([chunk, pad], axis=0)
        total, bsums = _pippenger_device(points, chunk, c)
        if total_host is None:
            total_host = og.jpoints_to_host(total)[0]
        bsums_host.extend(og.jpoints_to_host(bsums))
    return _combine_windows_host(total_host, bsums_host[:W], c, W)


# ---------------------------------------------------------------------------
# Host-sorted Pippenger: the digit sort runs on the host.
#
#   * HOST (numpy): digit extraction, per-window argsort (radix on uint16),
#     bucket-boundary searchsorted — O(W*n) integer work, milliseconds.
#   * DEVICE: the group arithmetic — gathering point records into
#     digit-sorted order, the 2n-add prefix scan per window, boundary prefix
#     extraction and the bucket-sum reduction.
# ---------------------------------------------------------------------------


def host_digits(scalars: np.ndarray, c: int, bits: int = FR_BITS) -> np.ndarray:
    """numpy twin of extract_digits: (L16, n) limbs -> (W, n) uint16 digits
    with W = ceil(bits / c) (bits < 16 * rows(scalars) + 1)."""
    if not 1 <= c <= 16:
        raise ValueError("window size must be in [1, 16]")
    W = -(-bits // c)
    s = np.concatenate(
        [scalars.astype(np.uint32), np.zeros((2,) + scalars.shape[1:], np.uint32)]
    )
    mask = np.uint32((1 << c) - 1)
    rows = []
    for w in range(W):
        i0, off = divmod(w * c, 16)
        v = s[i0] >> np.uint32(off)
        if off + c > 16:
            v = v | (s[i0 + 1] << np.uint32(16 - off))
        rows.append(v & mask)
    return np.stack(rows).astype(np.uint16)


@partial(jax.jit, static_argnames=("c",))
def _hostsort_window_partials(packed, order, e, mask, c: int):
    """Device pipeline for one window chunk, all inside a single dispatch.

    packed (49, n) u32 point records (x limbs 0-23, y limbs 24-47, inf 48);
    order (wb, n) i32 digit-sort permutations; e (wb, B-1) i32 bucket
    boundary indices into the sorted order; mask (wb, B-1) boundary-valid.
    Returns (total JPoints (24,), bucket-weighted boundary sums (24, wb)).
    """
    g = ogather.gather_u32_shared(packed, order)  # (49, wb, n)
    pts = APoints(g[:24], g[24:48], g[48] != 0)
    P = oscan.inclusive_scan(og.lift(pts))  # (24, wb, n) prefix sums
    btab = jnp.concatenate([P.x, P.y, P.z], axis=0)  # (72, wb, n)
    bg = ogather.gather_u32(btab, e)  # (72, wb, B-1)
    boundary = og.jselect(
        mask, JPoints(bg[:24], bg[24:48], bg[48:]), oscan.jinf(e.shape)
    )
    bsums = oscan.tree_reduce_hybrid(boundary)  # (24, wb)
    total = JPoints(P.x[:, 0, -1], P.y[:, 0, -1], P.z[:, 0, -1])
    return total, bsums


def hostsort_point_ops(n: int, c: int) -> int:
    """Group adds executed per MSM by the host-sorted Pippenger."""
    W = -(-FR_BITS // c)
    return W * (2 * n + (1 << c)) + 255


def msm_pippenger_hostsort(
    points: APoints,
    scalars: np.ndarray,
    c: Optional[int] = None,
    window_batch: Optional[int] = None,
) -> G1:
    """Full MSM: points (24, n) affine (device or host), scalars (16, n)
    canonical limbs as HOST numpy (the sort runs on host) -> host G1."""
    from curdleproofs_jax.utils.profiling import timed

    scalars_np = np.asarray(scalars).astype(np.uint32)
    n_in = points.x.shape[-1]
    c = c or pick_window(max(n_in, 32))
    with timed(
        "msm.hostsort", items=n_in, point_ops=hostsort_point_ops(n_in, c)
    ):
        return _msm_hostsort_impl(points, scalars_np, c, window_batch)


def _pad_records(points: APoints, scalars_np: np.ndarray, m: int):
    """Pad (points, host scalars) with identity lanes / zero scalars to m."""
    n_in = points.x.shape[-1]
    if m == n_in:
        return points, scalars_np
    zc = jnp.zeros((24, m - n_in), dtype=jnp.uint32)
    points = APoints(
        jnp.concatenate([points.x, zc], axis=-1),
        jnp.concatenate([points.y, zc], axis=-1),
        jnp.concatenate([points.inf, jnp.ones(m - n_in, dtype=bool)], axis=-1),
    )
    scalars_np = np.concatenate(
        [scalars_np, np.zeros((16, m - n_in), np.uint32)], axis=-1
    )
    return points, scalars_np


def _msm_hostsort_impl(
    points: APoints,
    scalars_np: np.ndarray,
    c: int,
    window_batch: Optional[int] = None,
) -> G1:
    m = 512
    while m < points.x.shape[-1]:
        m *= 2
    points, scalars_np = _pad_records(points, scalars_np, m)
    n = m
    W = -(-FR_BITS // c)
    B = 1 << c
    if window_batch is None:
        # bound the scan working set (~600 u32 rows per lane live) to ~1.5 GB
        window_batch = max(1, min(W, (1 << 22) // max(n, 1)))

    # --- host: digits, per-window radix argsort, bucket boundaries ---------
    digits = host_digits(scalars_np, c)  # (W, n) uint16
    order = np.argsort(digits, axis=-1, kind="stable").astype(np.int32)
    sd = np.take_along_axis(digits, order.astype(np.intp), axis=-1)
    ts = np.arange(B - 1, dtype=np.uint16)
    e = np.empty((W, B - 1), np.int32)
    for w in range(W):
        e[w] = np.searchsorted(sd[w], ts, side="right").astype(np.int32) - 1
    mask = e >= 0

    packed = jnp.concatenate(
        [points.x, points.y, points.inf[None].astype(jnp.uint32)], axis=0
    )

    pending = []
    for w0 in range(0, W, window_batch):
        ordc = order[w0 : w0 + window_batch]
        ec = e[w0 : w0 + window_batch]
        mc = mask[w0 : w0 + window_batch]
        wb = ordc.shape[0]
        if wb != window_batch:  # keep a single compiled shape per (n, c)
            pad = window_batch - wb
            ordc = np.concatenate([ordc, np.zeros((pad, n), np.int32)])
            ec = np.concatenate([ec, np.zeros((pad, B - 1), np.int32)])
            mc = np.concatenate([mc, np.zeros((pad, B - 1), bool)])
        total, bsums = _hostsort_window_partials(
            packed, jnp.asarray(ordc), jnp.asarray(ec), jnp.asarray(mc), c
        )
        pending.append((total, bsums))
    xs = [pending[0][0].x] + [b.x for _, b in pending]
    ys = [pending[0][0].y] + [b.y for _, b in pending]
    zs = [pending[0][0].z] + [b.z for _, b in pending]
    arr = np.asarray(_pack_stream_results(tuple(xs), tuple(ys), tuple(zs)))
    pts = og.jpoints_to_host(JPoints(arr[:24], arr[24:48], arr[48:]))
    return _combine_windows_host(pts[0], pts[1 : 1 + W], c, W)


# ---------------------------------------------------------------------------
# Streaming host-sorted Pippenger ("stream"): hostsort with the prefix scan
# restructured as the ops.stream_scan column-major streaming scan — n
# work-optimal MIXED adds per window instead of ~2.2n full adds — and only
# the B-1 bucket-boundary prefixes stitched together (local + lane-offset
# add), never a full prefix vector.
# ---------------------------------------------------------------------------


# GLV endomorphism split inside the stream engine (see _msm_stream_impl):
# halves the window count for the same scan work. Default on; kill switch
# for A/B measurement and for exercising the non-split path in tests.
STREAM_GLV = os.environ.get("CURDLEPROOFS_STREAM_GLV", "1") == "1"
GLV_STREAM_MIN_N = 128  # below this, decompose/packing overhead dominates


def stream_point_ops(n: int, c: int) -> int:
    """Group adds executed per MSM by the streaming host-sorted Pippenger:
    one mixed add per record + ~2 log2(L)*L lane-offset adds + 2(B-1)
    boundary/reduce adds per window, + the host window combine. With the
    GLV split the records double (2n lanes) but W halves."""
    from curdleproofs_jax.ops.stream_scan import pick_lanes

    m = 128
    while m < n:
        m *= 2
    if STREAM_GLV and m >= GLV_STREAM_MIN_N:
        W = -(-130 // c)
        n_eff = 2 * m
    else:
        W = -(-FR_BITS // c)
        n_eff = m
    L = pick_lanes(n_eff)
    return W * (n_eff + 2 * L.bit_length() * L + 2 * (1 << c)) + W * c + W


@jax.jit
def _glv_stream_packed(px, py, pinf, neg1):
    """Lane-doubled stream records for the GLV split: [sgn(neg1)·P | phi(P)]
    with phi(x, y) = (beta·x, y) and sgn negating y where s1 was negative.
    (24, n) Montgomery affine coords -> (49, 2n) packed records. Identity
    lanes ride on the inf flag (their 0-coords map to 0 under both ops)."""
    from curdleproofs_jax.ops import modarith as ma
    from curdleproofs_jax.ops.fieldspec import FQ_SPEC
    from curdleproofs_jax.ops.glv import beta_mont_limbs

    beta = jnp.broadcast_to(
        jnp.asarray(beta_mont_limbs(), dtype=jnp.uint32).reshape(24, 1), px.shape
    )
    y1 = ma.select(neg1, ma.neg(FQ_SPEC, py), py)
    x2 = ma.mont_mul(FQ_SPEC, px, beta)
    infu = pinf[None].astype(jnp.uint32)
    return jnp.concatenate(
        [
            jnp.concatenate([px, y1, infu], axis=0),
            jnp.concatenate([x2, py, infu], axis=0),
        ],
        axis=1,
    )


def _stream_body(packed, idx_cm, bidx, lidx, T: int, L: int, safe: bool):
    """Device pipeline for one window chunk (traced into one dispatch graph).

    packed (49, n) u32 point records; idx_cm (wb, n) i32 column-major
    digit-sort gather order; bidx (wb, B-1) i32 within-window flat positions
    (t*L + l) of bucket-boundary prefixes, -1 for empty; lidx (wb, B-1) i32
    within-window lane-offset positions (lane(e) - 1), -1 when lane(e) == 0
    or the boundary is empty. Out-of-range gathers return zeros, and an
    all-zero Jacobian triple has z == 0 == infinity, so no masking is needed
    anywhere.

    safe=False runs the doubling-free scan and also returns per-window
    doubling flags (the caller redoes the MSM with safe=True if any is set);
    safe=True runs the complete scan and returns all-zero flags.
    Returns (total JPoints (24,), bucket-weighted boundary sums (24, wb),
    flags (wb,) u32)."""
    from curdleproofs_jax.ops import stream_scan as ostream

    wb = idx_cm.shape[0]
    g = ogather.gather_u32_shared(packed, idx_cm).reshape(49, wb * T * L)
    if safe:
        prefix, totals = ostream.scan_records(g, wb, T, L)
        flags = jnp.zeros((wb,), jnp.uint32)
    else:
        prefix, totals, flags = ostream.scan_records_flagged(g, wb, T, L)
    lane_scan = oscan._hs_scan(
        JPoints(totals[:24], totals[24:48], totals[48:])
    )  # (24, wb, L) inclusive over lanes
    total = JPoints(
        lane_scan.x[:, 0, L - 1], lane_scan.y[:, 0, L - 1], lane_scan.z[:, 0, L - 1]
    )
    lane_tab = jnp.concatenate([lane_scan.x, lane_scan.y, lane_scan.z], axis=0)
    bl = ogather.gather_u32(prefix, bidx)  # (72, wb, B-1) local prefixes
    lo = ogather.gather_u32(lane_tab, lidx)  # (72, wb, B-1) lane offsets
    # sum_e (local_e + offset_e): one reduction over both tables (the group
    # is commutative), so the program holds no separate boundary add
    both = jnp.concatenate([bl, lo], axis=-1)  # (72, wb, 2(B-1))
    bsums = oscan.tree_reduce_hybrid(
        JPoints(both[:24], both[24:48], both[48:])
    )  # (24, wb)
    return total, bsums, flags


_stream_window_partials = jax.jit(
    _stream_body, static_argnames=("T", "L", "safe")
)


def stream_host_prep(digits: np.ndarray, c: int, L: int):
    """Host index prep for the streaming scan: digit-sort permutations in
    column-major device layout + bucket-boundary/lane-offset index tables.

    digits (W, n) uint16 -> (order_cm (W, n) i32, bidx (W, B-1) i32,
    lidx (W, B-1) i32, e (W, B-1) i64 raw boundary ranks)."""
    W, n = digits.shape
    T = n // L
    B = 1 << c
    order = np.argsort(digits, axis=-1, kind="stable").astype(np.int32)
    sd = np.take_along_axis(digits, order.astype(np.intp), axis=-1)
    ts = np.arange(B - 1, dtype=np.uint16)
    e = np.empty((W, B - 1), np.int64)
    for w in range(W):
        e[w] = np.searchsorted(sd[w], ts, side="right") - 1
    # column-major relabel: device flat position t*L + l holds sorted rank
    # l*T + t, so lane l's running prefix walks ranks [l*T, (l+1)*T)
    order_cm = np.ascontiguousarray(
        order.reshape(W, L, T).transpose(0, 2, 1)
    ).reshape(W, n)
    t_e, l_e = e % T, e // T
    bidx = np.where(e >= 0, t_e * L + l_e, -1).astype(np.int32)
    lidx = np.where((e >= 0) & (l_e > 0), l_e - 1, -1).astype(np.int32)
    return order_cm, bidx, lidx, e


@jax.jit
def _pack_stream_results(xs, ys, zs):
    """Concat ((24,) | (24, k)) coordinate groups into one (72, K) array so
    the results come home with a single device-to-host transfer."""

    def cat(parts):
        return jnp.concatenate([p.reshape(24, -1) for p in parts], axis=-1)

    return jnp.concatenate([cat(xs), cat(ys), cat(zs)], axis=0)


@jax.jit
def _pack_stream_results_flagged(xs, ys, zs, flags):
    """_pack_stream_results plus ONE trailing column whose first row is the
    OR of every chunk's doubling flags (flags: tuple of (wb,) u32) — the
    flag rides home inside the same single readback."""
    f = jnp.max(jnp.concatenate([jnp.atleast_1d(fl) for fl in flags]))
    col = jnp.zeros((72,), jnp.uint32).at[0].set(f).reshape(72, 1)
    return jnp.concatenate([_pack_stream_results(xs, ys, zs), col], axis=-1)


# Above this width one MSM runs as SLICES of this size plus one host add
# per extra slice: MSM is linear in its (point, scalar) pairs. Each slice
# re-picks its window bits at the slice size.
STREAM_SPLIT = 1 << 16


def msm_pippenger_stream(
    points: APoints,
    scalars: np.ndarray,
    c: Optional[int] = None,
    window_batch: Optional[int] = None,
) -> G1:
    """Full MSM via the streaming host-sorted Pippenger. points (24, n)
    affine (device or host), scalars (16, n) canonical limbs as HOST numpy
    (the sort runs on host) -> host G1. Widths above STREAM_SPLIT run as
    independent slices (each slice picks its own window bits) combined by
    plain addition."""
    from curdleproofs_jax.utils.profiling import timed

    scalars_np = np.asarray(scalars).astype(np.uint32)
    n_in = points.x.shape[-1]
    if n_in > STREAM_SPLIT:
        sz = STREAM_SPLIT
        cs = pick_window(sz)
        with timed(
            "msm.stream",
            items=n_in,
            point_ops=-(-n_in // sz) * stream_point_ops(sz, cs),
        ):
            # two slices in flight: slice k+1's host prep (native sort)
            # overlaps slice k's device execution and readback
            from concurrent.futures import ThreadPoolExecutor

            def one(o):
                sub = APoints(
                    points.x[:, o : o + sz],
                    points.y[:, o : o + sz],
                    points.inf[o : o + sz],
                )
                return _msm_stream_impl(
                    sub, scalars_np[:, o : o + sz], cs, window_batch
                )[0]

            acc = G1.identity()
            with ThreadPoolExecutor(max_workers=2) as pool:
                for r in pool.map(one, range(0, n_in, sz)):
                    acc = acc + r
            return acc
    c = c or pick_window(max(n_in, 32))
    with timed("msm.stream", items=n_in, point_ops=stream_point_ops(n_in, c)):
        return _msm_stream_impl(points, scalars_np, c, window_batch)[0]


def _stream_prep(scalars_np: np.ndarray, c: int, glv_split: bool):
    """Host prep: GLV split, digits, digit sort, boundary tables.
    Returns (neg1 or None, order_cm, bidx, lidx, lanes n, W, L)."""
    from curdleproofs_jax.ops.stream_scan import pick_lanes

    n = scalars_np.shape[1]
    B = 1 << c
    if glv_split:
        try:
            from curdleproofs_jax import _g1_native

            native_prep = _g1_native.msm_prep_batch
        except (ImportError, AttributeError):
            native_prep = None
        if native_prep is not None:
            # ONE native call (C, OpenMP): GLV split + digits + counting
            # sort + boundary ranks + column-major relabel. Its boundary-
            # selection schedule output is not used.
            n2 = 2 * n
            L = pick_lanes(n2)
            buf = np.ascontiguousarray(scalars_np.T.astype("<u2")).tobytes()
            nb, ob, bb, lb, _, _, _, W = native_prep(buf, c, L)
            neg1 = np.frombuffer(nb, np.uint8).astype(bool)
            order_cm = np.frombuffer(ob, np.int32).reshape(W, n2)
            bidx = np.frombuffer(bb, np.int32).reshape(W, B - 1)
            lidx = np.frombuffer(lb, np.int32).reshape(W, B - 1)
            return neg1, order_cm, bidx, lidx, n2, W, L
        from curdleproofs_jax.ops import glv as oglv

        s1, neg1, s2 = oglv.decompose(scalars_np.astype(np.uint64))
        # (ceil(130/c), 2n) — |s1| < 2^129 plus one bit of headroom
        digits = host_digits(
            np.concatenate([s1, s2], axis=1).astype(np.uint32), c, bits=130
        )
        n *= 2
    else:
        neg1 = None
        digits = host_digits(scalars_np, c)  # (W, n) uint16
    L = pick_lanes(n)
    order_cm, bidx, lidx, _ = stream_host_prep(digits, c, L)
    return neg1, order_cm, bidx, lidx, n, digits.shape[0], L


def _msm_stream_impl(
    points: APoints,
    scalars_np: np.ndarray,
    c: int,
    window_batch: Optional[int] = None,
    device=None,
    _safe: bool = False,
):
    """One stream MSM -> (host G1, the device its programs ran on).

    Every device input (points, records, index tables) is put on `device`
    (default: the device holding points.x, else JAX's default device), and
    the returned device is read off the result array itself."""
    if device is None:
        device = (
            next(iter(points.x.devices()))
            if isinstance(points.x, jax.Array)
            else jax.devices()[0]
        )

    def put(a):
        return jax.device_put(a, device)

    points = APoints(*(put(a) for a in points))
    m = 128
    while m < points.x.shape[-1]:
        m *= 2
    points_p, scalars_p = _pad_records(points, scalars_np, m)
    B = 1 << c
    # GLV endomorphism split (CURDLEPROOFS_STREAM_GLV=0 disables): each
    # 255-bit scalar becomes two <=129-bit halves k = (-1)^neg*s1 + s2*lam,
    # the lane set doubles to [+-P | phi(P)], and W halves (22 -> 11 at
    # c=12). Scan work is unchanged (W*n records either way) but every
    # per-window cost — bucket-boundary stitch, tree reduce, index-table
    # bytes, host window combine — halves with W.
    glv_split = STREAM_GLV and m >= GLV_STREAM_MIN_N
    neg1, order_cm, bidx, lidx, n, W, L = _stream_prep(scalars_p, c, glv_split)
    T = n // L

    if window_batch is None:
        # per-chunk live set: gathered records + full prefix table:
        # ~500 u32 rows per lane
        window_batch = max(1, min(W, (1 << 22) // max(n, 1)))
    # chunk sizes in window order; the last one repeats until W is covered
    schedule = (
        [window_batch] if isinstance(window_batch, int) else list(window_batch)
    )
    while sum(schedule) < W:
        schedule.append(schedule[-1])
    while sum(schedule[:-1]) >= W:
        schedule.pop()

    if glv_split:
        packed = _glv_stream_packed(
            points_p.x, points_p.y, points_p.inf, put(neg1)
        )
    else:
        packed = jnp.concatenate(
            [points_p.x, points_p.y, points_p.inf[None].astype(jnp.uint32)],
            axis=0,
        )

    pending = []  # device handles; dispatches stay async so chunk k+1's
    # host slicing and transfers overlap chunk k's device execution
    w0 = 0
    for cb in schedule:
        sl = slice(w0, w0 + cb)
        ordc, bc, lc = order_cm[sl], bidx[sl], lidx[sl]
        pad = cb - ordc.shape[0]
        if pad:  # keep one compiled shape per (n, c, chunk size)
            ordc = np.concatenate(
                [ordc, np.tile(np.arange(n, dtype=np.int32), (pad, 1))]
            )
            bc = np.concatenate([bc, np.full((pad, B - 1), -1, np.int32)])
            lc = np.concatenate([lc, np.full((pad, B - 1), -1, np.int32)])
        pending.append(
            _stream_window_partials(
                packed, put(ordc), put(bc), put(lc), T=T, L=L, safe=_safe
            )
        )
        w0 += cb

    # one readback for the total, every chunk's bucket sums and the flags
    res = _pack_stream_results_flagged(
        tuple([pending[0][0].x] + [b.x for _, b, _ in pending]),
        tuple([pending[0][0].y] + [b.y for _, b, _ in pending]),
        tuple([pending[0][0].z] + [b.z for _, b, _ in pending]),
        tuple(f for _, _, f in pending),
    )
    (ran_on,) = res.devices()
    arr = np.asarray(res)
    if arr[:, -1].any():
        # a p == q doubling collision hit the doubling-free scan (a running
        # prefix equal to its incoming base — essentially only constructible
        # on purpose). Redo on the doubling-safe scan: exact, ~1.5x once.
        return _msm_stream_impl(points, scalars_np, c, None, device, _safe=True)
    pts = og.jpoints_to_host(JPoints(arr[:24, :-1], arr[24:48, :-1], arr[48:, :-1]))
    return _combine_windows_host(pts[0], pts[1 : 1 + W], c, W), ran_on


def ladder_point_ops(n: int) -> int:
    """Group operations executed per lane by the GLV dual-table ladder MSM
    (doublings + window adds + table builds + endomorphism maps), plus the
    host sum."""
    return (129 + 86 + 6 + 7) * n + n


def msm_ladder(points: APoints, scalars) -> G1:
    """Ladder MSM: per-lane scalar multiplication at full batch width, then
    a sum. Zero sorts or gathers. The scalars ((16, n) canonical limbs) are
    GLV-split on the host and run through the shared 43-step dual-table
    ladder program (og.glv_scale); the n products are summed on the host."""
    from curdleproofs_jax.utils.profiling import timed

    n = points.x.shape[-1]
    with timed("msm.ladder", items=n, point_ops=ladder_point_ops(n)):
        return og.sum_to_host(og.glv_scale(points, scalars))[0]


# backwards-compatible alias (oracle/cross-check path in tests)
def msm_naive(points: APoints, scalars: jnp.ndarray) -> G1:
    return msm_ladder(points, scalars)


def msm_ladder_segmented(
    points: APoints, scalars_np: np.ndarray, K: int
) -> List[G1]:
    """K independent same-width MSMs as ONE device dispatch.

    points (24, K*m) affine, scalars (16, K*m) host numpy canonical limbs;
    segment k owns lanes [k*m, (k+1)*m). Returns the K segment results.
    This is the device engine behind lockstep batch *proving* (SURVEY §2.3
    batch parallelism): 64 concurrent ell=124 provers make every protocol
    MSM a 64x128-lane batch where the reference (msm_accumulator.py:6-12)
    loops point-by-point per proof."""
    from curdleproofs_jax.utils.profiling import timed

    n = points.x.shape[-1]
    if n % K:
        raise ValueError("segmented msm: width not divisible by K")
    with timed("msm.ladder_seg", items=n, point_ops=ladder_point_ops(n)):
        return og.sum_to_host(og.glv_scale(points, scalars_np), K)


# msm(method="auto") on the accelerator: the streaming Pippenger takes over
# from the ladder at this width (the ladder executes ~229 ops per lane, the
# stream ~25 plus its host sort and per-window overheads).
STREAM_MIN = int(os.environ.get("CURDLEPROOFS_STREAM_MIN", str(1 << 14)))


# Below this size exact host arithmetic beats a device dispatch round-trip
# (e.g. the verifier's log(n)-sized L/R gamma combinations).
HOST_THRESHOLD = 16


def _msm_host_timed(bases: Sequence[G1], scalars: Sequence[Fr]) -> G1:
    from curdleproofs_jax.curve import msm_host
    from curdleproofs_jax.utils.profiling import timed

    n = len(bases)
    # host Pippenger; the op count is the double-and-add model,
    # ~1.5 * 255 point ops per element
    with timed("msm.host", items=n, point_ops=383 * n):
        return msm_host(list(bases), list(scalars))


def msm(
    bases: Sequence[G1],
    scalars: Sequence[Fr],
    c: Optional[int] = None,
    method: str = "auto",
) -> G1:
    """Host-facing MSM over host points/scalars (compute_MSM equivalent).

    method="auto": the native host Pippenger up to HOST_THRESHOLD and
    whenever there is no accelerator; on the accelerator the ladder below
    STREAM_MIN and the streaming Pippenger from it on."""
    if len(bases) != len(scalars):
        raise ValueError("msm length mismatch")
    if not bases:
        return G1.identity()
    if method == "auto":
        if len(bases) <= HOST_THRESHOLD or not on_accelerator():
            return _msm_host_timed(bases, scalars)
        method = "stream" if len(bases) >= STREAM_MIN else "ladder"
    from curdleproofs_jax.ops.fieldspec import ints_to_limbs

    pts = og.pack_points(list(bases))
    if method in ("stream", "hostsort", "ladder"):
        scs_np = np.asarray(
            ints_to_limbs([s.v for s in scalars], 16), dtype=np.uint32
        )
        if method == "ladder":
            return msm_ladder(pts, scs_np)
        fn = msm_pippenger_stream if method == "stream" else msm_pippenger_hostsort
        return fn(pts, scs_np, c=c)
    return msm_pippenger(pts, og.pack_scalars(list(scalars)), c=c)
