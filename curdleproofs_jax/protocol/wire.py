"""Declarative wire codec for proof structures.

Every proof class declares a `WIRE` schema — an ordered tuple of
`(field_name, kind)` pairs — and this module derives all four serialization
directions (bytes out/in, JSON out/in) from it. The reference hand-writes
four methods per proof class (e.g. ipa.py:235-284, same_msm.py:228-285);
here the layout is data, written once.

Kinds:
  PT      one G1 point       -> 48-byte ZCash compressed / hex string
  FR      one Fr scalar      -> 32-byte canonical little-endian / hex string
  ROUNDS  a PointVec of lg2(n) fold-round points -> concatenated 48-byte
          encodings / list of hex strings (n = padded statement size)
  <class> a nested WIRE-bearing structure -> inlined bytes / nested object

Encodings are byte-identical to the reference wire format (SURVEY.md §3.5).
"""
from __future__ import annotations

from typing import Any, Dict, Type, TypeVar

from curdleproofs_jax.curve import G1
from curdleproofs_jax.fields import Fr
from curdleproofs_jax.utils.serde import BufReader, log2_int
from curdleproofs_jax.vectors import PointVec

PT = "pt"
FR = "fr"
ROUNDS = "rounds"

W = TypeVar("W", bound="WireStruct")


class WireStruct:
    """Mixin providing byte/JSON serde to any class with a WIRE schema.

    Subclasses keep the reference-compatible method surface
    (to_bytes / from_bytes(reader, n) / to_json / from_json).
    """

    WIRE: tuple = ()

    def to_bytes(self) -> bytes:
        chunks = []
        for name, kind in self.WIRE:
            value = getattr(self, name)
            if kind is PT:
                chunks.append(value.to_compressed_bytes())
            elif kind is FR:
                chunks.append(value.to_le_bytes())
            elif kind is ROUNDS:
                chunks.extend(value.compressed())
            else:
                chunks.append(value.to_bytes())
        return b"".join(chunks)

    @classmethod
    def _read(cls: Type[W], rd: BufReader, rounds: int) -> W:
        kwargs: Dict[str, Any] = {}
        for name, kind in cls.WIRE:
            if kind is PT:
                kwargs[name] = rd.read_g1()
            elif kind is FR:
                kwargs[name] = rd.read_fr()
            elif kind is ROUNDS:
                kwargs[name] = PointVec([rd.read_g1() for _ in range(rounds)])
            else:
                kwargs[name] = kind._read(rd, rounds)
        return cls(**kwargs)

    @classmethod
    def from_bytes(cls: Type[W], rd: BufReader, n: int = 0) -> W:
        """Decode from a fixed-layout buffer; `n` is the (power-of-two)
        statement size that fixes the fold-round count."""
        return cls._read(rd, log2_int(n) if n else 0)

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name, kind in self.WIRE:
            value = getattr(self, name)
            if kind is PT:
                out[name] = value.to_compressed_bytes().hex()
            elif kind is FR:
                out[name] = value.to_le_bytes().hex()
            elif kind is ROUNDS:
                out[name] = [enc.hex() for enc in value.compressed()]
            else:
                out[name] = value.to_json()
        return out

    @classmethod
    def from_json(cls: Type[W], data: Dict[str, Any]) -> W:
        kwargs: Dict[str, Any] = {}
        for name, kind in cls.WIRE:
            raw = data[name]
            if kind is PT:
                kwargs[name] = G1.from_compressed_bytes_unchecked(bytes.fromhex(raw))
            elif kind is FR:
                kwargs[name] = Fr.from_le_bytes(bytes.fromhex(raw))
            elif kind is ROUNDS:
                kwargs[name] = PointVec(
                    [
                        G1.from_compressed_bytes_unchecked(bytes.fromhex(h))
                        for h in raw
                    ]
                )
            else:
                kwargs[name] = kind.from_json(raw)
        return cls(**kwargs)
