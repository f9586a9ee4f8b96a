"""STROBE-128 duplex construction (the subset required by Merlin).

Behavioural spec: the Rust `strobe-rs`/`merlin` STROBE-128 instance — security
level 128, rate R = 166 bytes, protocol string "STROBEv1.0.2". Operations
supported: meta_AD, AD, PRF, KEY, exactly the ops Merlin transcripts use.

Reference parity: merlin_transcripts/merlin_transcripts/strobe.py:16-107
(bit-exact; conformance pinned by the Rust merlin crate's STROBE test vector).

This implementation buffers absorb/squeeze in bulk (slicing whole blocks per
permutation) rather than byte-at-a-time, so the Python fallback stays usable
for large transcripts; the hot permutation itself is the (optionally native)
Keccak-f[1600].
"""
from __future__ import annotations

from curdleproofs_jax.transcript.keccak import keccak_f1600

STROBE_R = 166  # rate in bytes for the 128-bit security level

FLAG_I = 1 << 0
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


class Strobe128:
    __slots__ = ("state", "pos", "pos_begin", "cur_flags")

    def __init__(self, protocol_label: bytes) -> None:
        st = bytearray(200)
        # F(([1, R+2, 1, 0, 1, 96*8/8] || "STROBEv1.0.2") padded to 200)
        st[0:6] = bytes((1, STROBE_R + 2, 1, 0, 1, 96))
        st[6:18] = b"STROBEv1.0.2"
        self.state = keccak_f1600(st)
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # -- public ops ---------------------------------------------------------

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytearray:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A | FLAG_C, more)
        self._overwrite(data)

    # -- internals ----------------------------------------------------------

    def _run_f(self) -> None:
        st = self.state
        st[self.pos] ^= self.pos_begin
        st[self.pos + 1] ^= 0x04
        st[STROBE_R + 1] ^= 0x80
        self.state = keccak_f1600(st)
        self.pos = 0
        self.pos_begin = 0

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if self.cur_flags != flags:
                raise ValueError(
                    f"STROBE op continuation with mismatched flags: "
                    f"{self.cur_flags:#x} != {flags:#x}"
                )
            return
        if flags & FLAG_T:
            raise ValueError("transport flags not supported")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes((old_begin, flags)))
        if flags & (FLAG_C | FLAG_K) and self.pos != 0:
            self._run_f()

    def _absorb(self, data: bytes) -> None:
        st, pos = self.state, self.pos
        off, n = 0, len(data)
        while off < n:
            take = min(STROBE_R - pos, n - off)
            # whole-slice XOR via int arithmetic (little-endian order is
            # irrelevant for a bytewise XOR; ~5x the per-byte Python loop)
            x = int.from_bytes(st[pos : pos + take], "little") ^ int.from_bytes(
                data[off : off + take], "little"
            )
            st[pos : pos + take] = x.to_bytes(take, "little")
            pos += take
            off += take
            if pos == STROBE_R:
                self.pos = pos
                self._run_f()
                st, pos = self.state, self.pos
        self.pos = pos

    def _overwrite(self, data: bytes) -> None:
        st, pos = self.state, self.pos
        off, n = 0, len(data)
        while off < n:
            take = min(STROBE_R - pos, n - off)
            st[pos : pos + take] = data[off : off + take]
            pos += take
            off += take
            if pos == STROBE_R:
                self.pos = pos
                self._run_f()
                st, pos = self.state, self.pos
        self.pos = pos

    def _squeeze(self, n: int) -> bytearray:
        out = bytearray()
        while len(out) < n:
            take = min(STROBE_R - self.pos, n - len(out))
            out += self.state[self.pos : self.pos + take]
            self.state[self.pos : self.pos + take] = bytes(take)
            self.pos += take
            if self.pos == STROBE_R:
                self._run_f()
        return out
