"""Vector-first value types for the protocol layer: `ScalarVec` and `PointVec`.

The reference manipulates Python lists of scalars/points one element at a
time (e.g. its per-element MSM loop, msm_accumulator.py:6-12, and fold loops,
ipa.py:142-151). This framework's protocol layer instead treats whole vectors
as single values. Every O(n) operation is one call that routes to the
best execution engine by size:

  * large vectors on the GPU -> the device engines (`ops.msm`,
    `ops.vector`): one device dispatch, device-resident packed arrays that
    are cached across calls (the CRS is packed once per process).
  * small vectors  -> the native C backend (`csrc/g1.c`): a protocol-sized
    proof does thousands of 10..256-element ops where a device round-trip
    costs more than the math.

`ScalarVec` is exact Fr arithmetic over NumPy object arrays (arbitrary
precision, vectorized on host — protocol-sized scalar work is always
host-latency-bound, so there is deliberately no device twin). Both types
are immutable — no in-place mutation hazards (the reference mutates prover
inputs, ipa.py:107-109).
"""
from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from curdleproofs_jax import curve as _cv
from curdleproofs_jax.curve import G1
from curdleproofs_jax.fields import FR_MOD, Fr

# Vectors at or above this length run on the accelerator; below it they run
# on the native C host backend (one shared-library call per vector op).
# Protocol-size proofs (n <= 256) are host-latency-bound; benchmark-size
# MSMs (2^16+) are device-throughput-bound.
DEVICE_MIN = int(os.environ.get("CURDLEPROOFS_DEVICE_MIN", "4096"))

_FrLike = Union[Fr, int]


def _lockstep_ctx():
    """Active lockstep batch context, if this thread is a batch-prover
    worker (utils.lockstep): point-ops then coalesce across K provers
    instead of routing by size."""
    from curdleproofs_jax.utils import lockstep

    return lockstep.current()


def _as_int(x: _FrLike) -> int:
    return x.v if isinstance(x, Fr) else x % FR_MOD


class ScalarVec:
    """Immutable vector over the BLS12-381 scalar field."""

    __slots__ = ("ints",)

    def __init__(self, ints: np.ndarray) -> None:
        # object-dtype array of Python ints, each already reduced mod r
        self.ints = ints

    # -- construction --------------------------------------------------------

    @classmethod
    def of(cls, items: Iterable[_FrLike]) -> "ScalarVec":
        vals = [_as_int(x) for x in items]
        a = np.empty(len(vals), dtype=object)
        a[:] = vals
        return cls(a)

    @classmethod
    def fill(cls, value: _FrLike, n: int) -> "ScalarVec":
        a = np.empty(n, dtype=object)
        a[:] = [_as_int(value)] * n
        return cls(a)

    @classmethod
    def powers(cls, base: _FrLike, n: int) -> "ScalarVec":
        """[1, base, base^2, ..., base^(n-1)]."""
        b = _as_int(base)
        vals, acc = [], 1
        for _ in range(n):
            vals.append(acc)
            acc = acc * b % FR_MOD
        a = np.empty(n, dtype=object)
        a[:] = vals
        return cls(a)

    # -- shape ---------------------------------------------------------------

    def __len__(self) -> int:
        return int(self.ints.shape[0])

    def __getitem__(self, i):
        if isinstance(i, slice):
            return ScalarVec(self.ints[i])
        return Fr(int(self.ints[i]))

    def split(self) -> Tuple["ScalarVec", "ScalarVec"]:
        h = len(self) // 2
        return ScalarVec(self.ints[:h]), ScalarVec(self.ints[h:])

    def cat(self, other: "ScalarVec") -> "ScalarVec":
        return ScalarVec(np.concatenate([self.ints, other.ints]))

    def tolist(self) -> List[Fr]:
        return [Fr(int(v)) for v in self.ints]

    def toints(self) -> List[int]:
        return [int(v) for v in self.ints]

    # -- arithmetic (elementwise; scalar operands broadcast) ------------------

    def _coerce(self, other):
        if isinstance(other, ScalarVec):
            return other.ints
        return _as_int(other)

    def __add__(self, other) -> "ScalarVec":
        return ScalarVec((self.ints + self._coerce(other)) % FR_MOD)

    def __sub__(self, other) -> "ScalarVec":
        return ScalarVec((self.ints - self._coerce(other)) % FR_MOD)

    def __mul__(self, other) -> "ScalarVec":
        return ScalarVec((self.ints * self._coerce(other)) % FR_MOD)

    __rmul__ = __mul__

    def __neg__(self) -> "ScalarVec":
        return ScalarVec((-self.ints) % FR_MOD)

    def dot(self, other: "ScalarVec") -> Fr:
        if len(self) != len(other):
            raise ValueError("dot: length mismatch")
        return Fr(int(np.add.reduce(self.ints * other.ints) % FR_MOD))

    def sum(self) -> Fr:
        return Fr(int(np.add.reduce(self.ints) % FR_MOD))

    def prefix_products(self) -> "ScalarVec":
        """[x0, x0*x1, ...] — the grand-product partials."""
        out, acc = [], 1
        for v in self.ints:
            acc = acc * int(v) % FR_MOD
            out.append(acc)
        a = np.empty(len(out), dtype=object)
        a[:] = out
        return ScalarVec(a)

    def product(self) -> Fr:
        acc = 1
        for v in self.ints:
            acc = acc * int(v) % FR_MOD
        return Fr(acc)

    def inverted(self) -> "ScalarVec":
        """Elementwise inverse via Montgomery's batch trick: one modular
        inversion + 3(n-1) multiplications for the whole vector."""
        vals = self.toints()
        pre, acc = [], 1
        for v in vals:
            pre.append(acc)
            acc = acc * v % FR_MOD
        if acc == 0:
            raise ZeroDivisionError("inverted(): vector contains zero")
        inv = pow(acc, -1, FR_MOD)
        out = [0] * len(vals)
        for i in range(len(vals) - 1, -1, -1):
            out[i] = inv * pre[i] % FR_MOD
            inv = inv * vals[i] % FR_MOD
        a = np.empty(len(out), dtype=object)
        a[:] = out
        return ScalarVec(a)

    def permuted(self, sigma: Sequence[int]) -> "ScalarVec":
        """[self[sigma[i]]] (reference get_permutation, util.py:93-96)."""
        return ScalarVec(self.ints[np.asarray(list(sigma))])

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, ScalarVec):
            return NotImplemented
        return len(self) == len(other) and bool(np.all(self.ints == other.ints))

    def __hash__(self):
        return hash(tuple(self.toints()))

    def __repr__(self) -> str:
        return f"ScalarVec(n={len(self)})"


class PointVec:
    """Immutable vector of G1 points with size-routed batched operations.

    Holds a host-side point list and, once any device op runs, a cached
    device-resident packed limb array (`ops.g1.APoints`) so repeated MSMs
    over the same basis (the CRS case) pack exactly once.
    """

    __slots__ = ("_pts", "_dev", "_enc")

    def __init__(self, points: Sequence[G1]) -> None:
        self._pts = list(points)
        self._dev = None
        self._enc: Optional[bytes] = None

    @classmethod
    def single(cls, p: G1) -> "PointVec":
        return cls([p])

    # -- shape / access -------------------------------------------------------

    def __len__(self) -> int:
        return len(self._pts)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return PointVec(self._pts[i])
        return self._pts[i]

    def __iter__(self):
        return iter(self._pts)

    def split(self) -> Tuple["PointVec", "PointVec"]:
        h = len(self._pts) // 2
        return PointVec(self._pts[:h]), PointVec(self._pts[h:])

    def cat(self, other: "PointVec") -> "PointVec":
        return PointVec(self._pts + other._pts)

    def append(self, p: G1) -> "PointVec":
        return PointVec(self._pts + [p])

    def tolist(self) -> List[G1]:
        return list(self._pts)

    # -- serde ----------------------------------------------------------------

    def compressed(self) -> List[bytes]:
        """Per-point 48-byte compressed encodings (one native call, cached —
        the CRS vectors are re-absorbed/deduped many times per proof)."""
        if self._enc is None:
            self._enc = _cv.compress_host_batch(self._pts)
        blob = self._enc
        return [blob[48 * i : 48 * i + 48] for i in range(len(self._pts))]

    # -- batched group operations ----------------------------------------------

    def _device(self):
        from curdleproofs_jax.ops import g1 as og

        if self._dev is None:
            self._dev = og.pack_points(self._pts)
        return self._dev

    def msm(self, scalars: ScalarVec) -> G1:
        """<scalars, self> — THE hot operation; device Pippenger/ladder for
        large n, native C Pippenger for protocol-size n."""
        n = len(self._pts)
        if len(scalars) != n:
            raise ValueError("msm: length mismatch")
        if n == 0:
            return G1.identity()
        ctx = _lockstep_ctx()
        if ctx is not None:
            return ctx.msm(self._pts, scalars.tolist())
        if n < DEVICE_MIN:
            return _cv.msm_host(self._pts, scalars.tolist())
        from curdleproofs_jax.ops import msm as omsm

        return omsm.msm(self._pts, scalars.tolist(), method="auto")

    def scaled(self, scalars: Union[ScalarVec, _FrLike]) -> "PointVec":
        """[P_i * s_i] (or a common scalar broadcast)."""
        n = len(self._pts)
        sv = (
            scalars
            if isinstance(scalars, ScalarVec)
            else ScalarVec.fill(_as_int(scalars), n)
        )
        if len(sv) != n:
            raise ValueError("scaled: length mismatch")
        ctx = _lockstep_ctx()
        if ctx is not None:
            return PointVec(ctx.scaled(self._pts, sv.tolist()))
        if n < DEVICE_MIN:
            return PointVec(_cv.mul_host_batch(self._pts, sv.tolist()))
        from curdleproofs_jax.ops import vector as ovec

        return PointVec(ovec.scale_points(self._pts, sv.tolist()))

    def __add__(self, other: "PointVec") -> "PointVec":
        n = len(self._pts)
        if len(other) != n:
            raise ValueError("add: length mismatch")
        ctx = _lockstep_ctx()
        if ctx is not None:
            return PointVec(ctx.add(self._pts, other._pts))
        if n < DEVICE_MIN:
            return PointVec(_cv.add_host_batch(self._pts, other._pts))
        from curdleproofs_jax.ops import vector as ovec

        return PointVec(ovec.add_points(self._pts, other._pts))

    def folded(self, gamma: Fr) -> "PointVec":
        """Halve the vector: lo_i + gamma * hi_i (the Bulletproofs fold)."""
        lo, hi = self.split()
        n = len(lo)
        ctx = _lockstep_ctx()
        if ctx is not None:
            return PointVec(ctx.folded(lo._pts, hi._pts, gamma))
        if n < DEVICE_MIN:
            return PointVec(
                _cv.add_host_batch(
                    lo._pts, _cv.mul_host_batch(hi._pts, [gamma] * n)
                )
            )
        from curdleproofs_jax.ops import vector as ovec

        return PointVec(ovec.fold_points(lo._pts, hi._pts, gamma))

    def permuted(self, sigma: Sequence[int]) -> "PointVec":
        """[self[sigma[i]]] — reorder by permutation indices."""
        return PointVec([self._pts[int(i)] for i in sigma])

    def sum(self) -> G1:
        return _cv.g1_sum(self._pts)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, PointVec):
            return NotImplemented
        return self._pts == other._pts

    def __repr__(self) -> str:
        return f"PointVec(n={len(self._pts)})"


def as_points(x: Union[PointVec, Sequence[G1]]) -> PointVec:
    """Coerce a G1 sequence to PointVec (no copy if already one)."""
    return x if isinstance(x, PointVec) else PointVec(x)


def as_scalars(x: Union[ScalarVec, Iterable[_FrLike]]) -> ScalarVec:
    """Coerce an Fr/int sequence to ScalarVec (no copy if already one)."""
    return x if isinstance(x, ScalarVec) else ScalarVec.of(x)


def msm(points: Union[PointVec, Sequence[G1]], scalars) -> G1:
    """Convenience MSM over any point/scalar sequence pairing."""
    return as_points(points).msm(as_scalars(scalars))
