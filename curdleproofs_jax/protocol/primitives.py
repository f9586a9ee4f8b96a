"""Commitment primitives, the CRS, and the deferred-MSM verification batcher.

All three are vector-first: the CRS holds its generator vectors as PointVec
(so their packed device form is cached across every MSM that reuses them),
and the accumulator collapses ALL verifier equations of one-or-many proofs
into a single large MSM executed once, on device for large sizes.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import ClassVar, List, Optional, Sequence, Tuple

from curdleproofs_jax.curve import G1, decompress_host_batch
from curdleproofs_jax.fields import FR_MOD, Fr
from curdleproofs_jax.protocol.wire import FR, PT, WireStruct
from curdleproofs_jax.utils.errors import InvalidInputError, check
from curdleproofs_jax.utils.rng import ProofRng, default_rng
from curdleproofs_jax.utils.serde import BufReader
from curdleproofs_jax.vectors import PointVec, ScalarVec, as_points, as_scalars

# 48-byte encoding of the point at infinity (flag byte 0xC0) — the one base
# encoding the accumulator drops, since infinity contributes nothing.
_INF_ENC = bytes([0xC0]) + bytes(47)


@dataclass(frozen=True, eq=False)
class GroupCommitment(WireStruct):
    """ElGamal-style Pedersen commitment to a *group element*:
    Com(T; r) = (G*r, T + H*r). Homomorphic in both slots.
    Reference behaviour: curdleproofs/commitment.py:14-73."""

    T_1: G1
    T_2: G1

    WIRE: ClassVar = (("T_1", PT), ("T_2", PT))

    @classmethod
    def new(cls, crs_G: G1, crs_H: G1, T: G1, r: Fr) -> "GroupCommitment":
        return cls(crs_G * r, T + crs_H * r)

    def __add__(self, other: "GroupCommitment") -> "GroupCommitment":
        if not isinstance(other, GroupCommitment):
            return NotImplemented
        return GroupCommitment(self.T_1 + other.T_1, self.T_2 + other.T_2)

    def __mul__(self, scalar: Fr) -> "GroupCommitment":
        if not isinstance(scalar, Fr):
            return NotImplemented
        return GroupCommitment(self.T_1 * scalar, self.T_2 * scalar)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, GroupCommitment):
            return NotImplemented
        return self.T_1 == other.T_1 and self.T_2 == other.T_2


class CurdleproofsCrs:
    """Common reference string: generator vectors vec_G[ell] / vec_H[nb],
    singles H, G_t, G_u, and the precomputed sums the grand-product verifier
    needs (reference crs.py:19-66). ell + n_blinders must be a power of two.

    vec_G / vec_H are PointVec — their packed device representation is
    created once and reused by every proof over this CRS."""

    __slots__ = ("vec_G", "vec_H", "H", "G_t", "G_u", "G_sum", "H_sum")

    def __init__(
        self,
        vec_G,
        vec_H,
        H: G1,
        G_t: G1,
        G_u: G1,
        G_sum: G1,
        H_sum: G1,
    ) -> None:
        self.vec_G = as_points(vec_G)
        self.vec_H = as_points(vec_H)
        self.H = H
        self.G_t = G_t
        self.G_u = G_u
        self.G_sum = G_sum
        self.H_sum = H_sum

    @property
    def ell(self) -> int:
        return len(self.vec_G)

    @property
    def n_blinders(self) -> int:
        return len(self.vec_H)

    @classmethod
    def new(
        cls, ell: int, n_blinders: int, rng: Optional[ProofRng] = None
    ) -> "CurdleproofsCrs":
        rng = rng or default_rng()
        gen = G1.generator()
        points = [gen * rng.random_scalar() for _ in range(ell + n_blinders + 3)]
        return cls.from_random_points(ell, n_blinders, points)

    @classmethod
    def from_random_points(
        cls, ell: int, n_blinders: int, points: Sequence[G1]
    ) -> "CurdleproofsCrs":
        total = ell + n_blinders
        if total <= 0 or total & (total - 1):
            raise InvalidInputError(
                f"ell + n_blinders must be a power of two "
                f"(ell={ell}, n_blinders={n_blinders})"
            )
        if len(points) < total + 3:
            raise InvalidInputError(
                f"need {total + 3} CRS points, got {len(points)}"
            )
        vec_G = PointVec(points[:ell])
        vec_H = PointVec(points[ell:total])
        return cls(
            vec_G,
            vec_H,
            H=points[total],
            G_t=points[total + 1],
            G_u=points[total + 2],
            G_sum=vec_G.sum(),
            H_sum=vec_H.sum(),
        )

    # -- serde ----------------------------------------------------------------

    def _singles(self) -> Tuple[G1, ...]:
        return (self.H, self.G_t, self.G_u, self.G_sum, self.H_sum)

    def to_json(self) -> str:
        return json.dumps(
            {
                "vec_G": [e.hex() for e in self.vec_G.compressed()],
                "vec_H": [e.hex() for e in self.vec_H.compressed()],
                "H": self.H.to_compressed_bytes().hex(),
                "G_t": self.G_t.to_compressed_bytes().hex(),
                "G_u": self.G_u.to_compressed_bytes().hex(),
                "G_sum": self.G_sum.to_compressed_bytes().hex(),
                "H_sum": self.H_sum.to_compressed_bytes().hex(),
            }
        )

    @classmethod
    def from_json(cls, json_str: str) -> "CurdleproofsCrs":
        d = json.loads(json_str)
        blob = bytes.fromhex(
            "".join(d["vec_G"])
            + "".join(d["vec_H"])
            + d["H"]
            + d["G_t"]
            + d["G_u"]
            + d["G_sum"]
            + d["H_sum"]
        )
        pts = decompress_host_batch(blob)
        ell, nb = len(d["vec_G"]), len(d["vec_H"])
        return cls(
            PointVec(pts[:ell]),
            PointVec(pts[ell : ell + nb]),
            *pts[ell + nb :],
        )

    def to_bytes(self) -> bytes:
        return b"".join(
            self.vec_G.compressed()
            + self.vec_H.compressed()
            + [p.to_compressed_bytes() for p in self._singles()]
        )

    @classmethod
    def from_bytes(
        cls, rd: BufReader, ell: int, n_blinders: int
    ) -> "CurdleproofsCrs":
        pts = [rd.read_g1() for _ in range(ell + n_blinders + 5)]
        return cls(
            PointVec(pts[:ell]),
            PointVec(pts[ell : ell + n_blinders]),
            *pts[ell + n_blinders :],
        )


class MSMAccumulator:
    """Deferred batch verification of MSM equations C_j =? <s_j, B_j>.

    Each accumulated check records (rho_j, C_j, bases, rho_j * scalars) with
    a fresh random rho_j. verify() then runs exactly TWO MSMs:
      lhs  = <rho, C>                                   (one small MSM)
      rhs  = <merged scalars, deduped bases>            (one large MSM)
    Bases are deduped across all checks by their 48-byte encoding (points
    are unhashable by design, matching the reference backend) and infinity
    bases are dropped — semantics of msm_accumulator.py:32-68, executed as
    two batched dispatches instead of per-element accumulation."""

    def __init__(self, rng: Optional[ProofRng] = None) -> None:
        self._rng = rng or default_rng()
        self._commitments: List[G1] = []
        self._rhos: List[Fr] = []
        self._terms: List[Tuple[PointVec, ScalarVec]] = []

    def accumulate_check(self, C: G1, bases, scalars) -> None:
        pv = as_points(bases)
        sv = as_scalars(scalars)
        if len(pv) != len(sv):
            raise ValueError("accumulate_check length mismatch")
        rho = self._rng.random_scalar()
        self._commitments.append(C)
        self._rhos.append(rho)
        self._terms.append((pv, sv * rho))

    def absorb(self, other: "MSMAccumulator") -> None:
        """Fold another accumulator's pending checks into this one (used to
        merge per-thread accumulators from parallel batch verification)."""
        self._commitments.extend(other._commitments)
        self._rhos.extend(other._rhos)
        self._terms.extend(other._terms)

    def verify(self) -> None:
        lhs = PointVec(self._commitments).msm(ScalarVec.of(self._rhos))

        # dedup by encoding but keep the first-seen point OBJECT — no
        # decompression (sqrt chains) needed to rebuild the basis
        merged: dict = {}
        for pv, sv in self._terms:
            encs = pv.compressed()
            for i, s in enumerate(sv.toints()):
                enc = encs[i]
                if enc == _INF_ENC:
                    continue
                prev = merged.get(enc)
                if prev is None:
                    merged[enc] = [pv[i], s]
                else:
                    prev[1] = (prev[1] + s) % FR_MOD
        bases = PointVec([p for p, _ in merged.values()])
        rhs = bases.msm(ScalarVec.of([s for _, s in merged.values()]))
        check(rhs == lhs, "batched MSM accumulator check failed")
