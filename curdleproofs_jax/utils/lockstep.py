"""Lockstep batch-proving executor: K provers, ONE device dispatch per step.

The reference proves one shuffle at a time, crossing into its native backend
per point operation (msm_accumulator.py:6-12). At Whisk protocol size
(ell=124) a single proof's MSMs are only ~128 points — too small to feed a
device. But K independent provers over the same CRS execute the *identical*
sequence of vector point-ops (same sizes, same order: the transcript only
influences scalar values, never control flow), so K proofs can run in
lockstep: worker threads execute the unmodified protocol code, and every
`PointVec` operation is intercepted and parked at a barrier until all K
workers have submitted the same step, then executed as ONE merged batch —
on the accelerator when the merged width clears the device threshold, else as one
native host call.

This realizes SURVEY §2.3 "batch parallelism over proofs" on the *proving*
side (the verify side already batches through the shared MSMAccumulator).
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

from curdleproofs_jax import curve as _cv
from curdleproofs_jax.curve import G1
from curdleproofs_jax.fields import Fr

_tls = threading.local()


def current() -> Optional["LockstepContext"]:
    """The batch context owning the calling thread, if any."""
    return getattr(_tls, "ctx", None)


class LockstepError(RuntimeError):
    """A worker diverged from the common op schedule (a bug, not bad input)."""


class LockstepContext:
    """Coalesces the k-th point-op of every worker into one merged call."""

    def __init__(self, K: int, device_min: int) -> None:
        self.K = K
        self.device_min = device_min
        self._slots: List[Any] = [None] * K
        self._results: List[Any] = [None] * K
        self._failure: Optional[BaseException] = None
        self._barrier = threading.Barrier(K, action=self._execute_merged)

    # -- worker side ---------------------------------------------------------

    def _submit(self, kind: str, payload: Tuple) -> Any:
        i: int = _tls.widx
        self._slots[i] = (kind, payload)
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError:
            # another worker failed and aborted the round
            raise self._failure or LockstepError("lockstep batch aborted")
        if self._failure is not None:
            raise self._failure
        return self._results[i]

    def msm(self, points: Sequence[G1], scalars: Sequence[Fr]) -> G1:
        return self._submit("msm", (list(points), list(scalars)))

    def scaled(self, points: Sequence[G1], scalars: Sequence[Fr]) -> List[G1]:
        return self._submit("scaled", (list(points), list(scalars)))

    def add(self, a: Sequence[G1], b: Sequence[G1]) -> List[G1]:
        return self._submit("add", (list(a), list(b)))

    def folded(self, lo: Sequence[G1], hi: Sequence[G1], gamma: Fr) -> List[G1]:
        return self._submit("folded", (list(lo), list(hi), gamma))

    # -- coordinator side (runs on the last thread to reach the barrier) ------

    def _execute_merged(self) -> None:
        try:
            kinds = {s[0] for s in self._slots}
            ns = {len(s[1][0]) for s in self._slots}
            if len(kinds) != 1 or len(ns) != 1:
                raise LockstepError(
                    f"diverged op schedule: kinds={kinds} widths={ns}"
                )
            kind = self._slots[0][0]
            getattr(self, "_merge_" + kind)()
        except BaseException as e:  # surfaced on every worker
            self._failure = e

    def _use_device(self, total: int) -> bool:
        from curdleproofs_jax.ops.device import on_accelerator

        return on_accelerator() and total >= self.device_min

    def _merge_msm(self) -> None:
        import numpy as np

        n = len(self._slots[0][1][0])
        K = self.K
        # pad each segment to a power of two and to a 128-multiple total so
        # the whole protocol hits a handful of compiled kernel shapes
        m = 1
        while m < n or K * m % 128:
            m *= 2
        if not self._use_device(K * m):
            for i, (_, (pts, scs)) in enumerate(self._slots):
                self._results[i] = _cv.msm_host(pts, scs)
            return
        from curdleproofs_jax.ops import g1 as og
        from curdleproofs_jax.ops import msm as omsm
        from curdleproofs_jax.ops.fieldspec import ints_to_limbs

        pts_flat: List[G1] = []
        ints_flat: List[int] = []
        pad_p = [G1.identity()] * (m - n)
        pad_s = [0] * (m - n)
        for _, (pts, scs) in self._slots:
            pts_flat += list(pts) + pad_p
            ints_flat += [s.v for s in scs] + pad_s
        packed = og.pack_points(pts_flat)
        scs_np = np.asarray(ints_to_limbs(ints_flat, 16), dtype=np.uint32)
        self._results = omsm.msm_ladder_segmented(packed, scs_np, K)

    def _merge_scaled(self) -> None:
        pts_flat: List[G1] = []
        scs_flat: List[Fr] = []
        for _, (pts, scs) in self._slots:
            pts_flat += pts
            scs_flat += scs
        if self._use_device(len(pts_flat)):
            from curdleproofs_jax.ops import vector as ovec

            out = ovec.scale_points(pts_flat, scs_flat)
        else:
            out = _cv.mul_host_batch(pts_flat, scs_flat)
        self._scatter(out)

    def _merge_add(self) -> None:
        a_flat: List[G1] = []
        b_flat: List[G1] = []
        for _, (a, b) in self._slots:
            a_flat += a
            b_flat += b
        if self._use_device(len(a_flat)):
            from curdleproofs_jax.ops import vector as ovec

            out = ovec.add_points(a_flat, b_flat)
        else:
            out = _cv.add_host_batch(a_flat, b_flat)
        self._scatter(out)

    def _merge_folded(self) -> None:
        lo_flat: List[G1] = []
        hi_flat: List[G1] = []
        g_flat: List[Fr] = []
        for _, (lo, hi, gamma) in self._slots:
            lo_flat += lo
            hi_flat += hi
            g_flat += [gamma] * len(lo)
        if self._use_device(len(lo_flat)):
            from curdleproofs_jax.ops import vector as ovec

            out = ovec.fold_points_multi(lo_flat, hi_flat, g_flat)
        else:
            out = _cv.add_host_batch(lo_flat, _cv.mul_host_batch(hi_flat, g_flat))
        self._scatter(out)

    def _scatter(self, flat: List[G1]) -> None:
        off = 0
        for i, (_, payload) in enumerate(self._slots):
            n = len(payload[0])
            self._results[i] = flat[off : off + n]
            off += n


def run_lockstep(
    fns: Sequence[Callable[[], Any]], device_min: Optional[int] = None
) -> List[Any]:
    """Run K closures in lockstep; returns their results in order.

    Every closure MUST execute the same sequence of PointVec operations
    (same kinds and widths) — true for provers over the same CRS/ell. A
    single closure runs inline with no batching machinery."""
    if len(fns) == 1:
        return [fns[0]()]
    from curdleproofs_jax import vectors as _v

    ctx = LockstepContext(len(fns), device_min or _v.DEVICE_MIN)
    results: List[Any] = [None] * len(fns)
    errors: List[Optional[BaseException]] = [None] * len(fns)

    def work(i: int) -> None:
        _tls.ctx = ctx
        _tls.widx = i
        try:
            results[i] = fns[i]()
        except BaseException as e:
            errors[i] = e
            ctx._failure = ctx._failure or e
            ctx._barrier.abort()
        finally:
            _tls.ctx = None

    threads = [
        threading.Thread(target=work, args=(i,), name=f"lockstep-{i}")
        for i in range(len(fns))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    return results
