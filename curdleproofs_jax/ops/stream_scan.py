"""Streaming group-prefix-scan over digit-sorted point records.

Phase 1 of the host-sorted streaming Pippenger MSM (ops.msm): n work-optimal
*mixed* adds per window instead of the ~2.2n full adds of the level
recursion (ops.scan.inclusive_scan).

  * The n sorted points of each window are laid out column-major over L
    lanes: lane l holds sorted ranks [l*T, (l+1)*T), and a `lax.scan` walks
    t = 0..T-1 with the running per-lane prefix as its carry. Each step is
    one complete Jacobian+affine mixed add (~11 Montgomery muls) over the
    W*L lanes of every window in the chunk.
  * Per-lane totals come out as the final carry; a small Hillis-Steele scan
    over the L lanes (ops.scan._hs_scan) turns them into lane offsets, and
    bucket-boundary prefixes are reassembled as
    prefix[e] = local_prefix[e] + lane_offset[lane(e) - 1] — only the B-1
    boundary positions per window are materialized (ops.msm), never a
    globally-stitched prefix vector.

The reference computes every MSM as a serial point loop
(msm_accumulator.py:6-12); this scan is part of its replacement.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from curdleproofs_jax.ops import g1 as og


def pick_lanes(n: int) -> int:
    """Scan lane width L for n records per window (n a power of two >= 128).

    The scan runs T = n / L sequential steps of W*L lanes each; on the GPU
    a step is a fixed chain of kernel launches whatever its width, so the
    rule caps T at 32 (L = n / 32), with L >= 512 (or n) so small MSMs keep
    few, full steps. A wider L costs a longer lane-offset stitch
    (log2(L) steps of full-width adds). The measurement behind the rule is
    in ROADMAP.md."""
    return max(n // 32, min(n, 512))


def _records(records: jnp.ndarray, W: int, T: int, L: int):
    rec = records.reshape(49, W, T, L)
    return rec[:24], rec[24:48], rec[48] != 0


def _unscan(a):
    """(T, 24, W, L) per-step outputs -> (24, W, T*L), flat pos t*L + l."""
    T, R, W, L = a.shape
    return jnp.moveaxis(a, 0, 2).reshape(R, W, T * L)


def scan_records(records: jnp.ndarray, W: int, T: int, L: int):
    """Per-lane streaming scan with the complete (doubling-safe) mixed add.

    records (49, W*T*L) u32 [x limbs 0-23, y 24-47, inf 48; flat position
    w*T*L + t*L + l holds sorted rank l*T + t of window w]. Returns
    (prefix (72, W, T*L), lane_totals (72, W, L)); prefix[.., w, p] is the
    inclusive within-lane prefix at flat position p = t*L + l, i.e. of
    sorted ranks [l*T, l*T + t] only."""
    x, y, infv = _records(records, W, T, L)

    def step(acc, t):
        res = og.jmadd(acc, og.APoints(x[:, :, t], y[:, :, t], infv[:, t]))
        return res, res

    acc_t, ys = jax.lax.scan(step, og.jinf((W, L)), jnp.arange(T))
    pref = jnp.concatenate([_unscan(ys.x), _unscan(ys.y), _unscan(ys.z)], axis=0)
    tot = jnp.concatenate([acc_t.x, acc_t.y, acc_t.z], axis=0)
    return pref, tot


def scan_records_flagged(records: jnp.ndarray, W: int, T: int, L: int):
    """scan_records with the doubling-free mixed add (og.jmadd_flagged):
    ~1/3 fewer field muls per step. Also returns per-window doubling flags
    (W,) u32, nonzero where a running prefix equalled its incoming base and
    the window's result is INVALID; the caller must then redo the MSM on
    the doubling-safe scan_records path."""
    x, y, infv = _records(records, W, T, L)

    def step(carry, t):
        acc, f = carry
        q = og.APoints(x[:, :, t], y[:, :, t], infv[:, t])
        res, dbl = og.jmadd_flagged(acc, q)
        return (res, f | dbl.astype(jnp.uint32)), res

    (acc_t, fl), ys = jax.lax.scan(
        step,
        (og.jinf((W, L)), jnp.zeros((W, L), jnp.uint32)),
        jnp.arange(T),
    )
    pref = jnp.concatenate([_unscan(ys.x), _unscan(ys.y), _unscan(ys.z)], axis=0)
    tot = jnp.concatenate([acc_t.x, acc_t.y, acc_t.z], axis=0)
    return pref, tot, jnp.max(fl, axis=-1)
