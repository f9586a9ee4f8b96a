"""Keccak-f[1600] permutation.

Implemented from the Keccak specification (FIPS 202 / keccak.team reference
spec) on a flat 25-lane uint64 state with precomputed rho/pi tables. This is
the permutation underneath STROBE-128 / Merlin transcripts; it must be
bit-exact with the Rust `merlin` crate (validated by the STROBE conformance
vectors in tests/test_transcript.py).

Reference parity: merlin_transcripts/merlin_transcripts/keccak.py (same
function, different implementation). A native C implementation is provided in
csrc/keccak.c and used automatically when built; this file is the portable
fallback and the behavioural spec.
"""
from __future__ import annotations

MASK64 = (1 << 64) - 1

# Round constants for the iota step (standard Keccak-f[1600] table).
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# Combined rho rotation + pi permutation, precomputed for the flat layout
# lane[i] = A[x][y] with i = x + 5*y.  After rho+pi, lane j of the new state
# B comes from lane _PI_SRC[j] of A rotated left by _RHO[j].
def _build_tables():
    # rho offsets in (x, y) indexing, from the spec's t-iteration.
    rho = [[0] * 5 for _ in range(5)]
    x, y = 1, 0
    for t in range(24):
        rho[x][y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    # pi: B[y][2x+3y] = A[x][y]
    src = [0] * 25
    rot = [0] * 25
    for x in range(5):
        for y in range(5):
            j = y + 5 * ((2 * x + 3 * y) % 5)
            src[j] = x + 5 * y
            rot[j] = rho[x][y]
    return src, rot


_PI_SRC, _ROT = _build_tables()


def _rotl(v: int, n: int) -> int:
    if n == 0:
        return v
    return ((v << n) | (v >> (64 - n))) & MASK64


def keccak_f1600_lanes(lanes: list) -> list:
    """Apply Keccak-f[1600] to a flat list of 25 uint64 lanes (i = x + 5y)."""
    a = list(lanes)
    for rnd in range(24):
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        # rho + pi
        b = [_rotl(a[_PI_SRC[j]], _ROT[j]) for j in range(25)]
        # chi
        a = [
            b[j] ^ ((b[(j % 5 + 1) % 5 + 5 * (j // 5)] ^ MASK64) & b[(j % 5 + 2) % 5 + 5 * (j // 5)])
            for j in range(25)
        ]
        # iota
        a[0] ^= _RC[rnd]
    return a


def keccak_f1600(state: bytes) -> bytearray:
    """Apply Keccak-f[1600] to a 200-byte state (little-endian lanes)."""
    lanes = [int.from_bytes(state[8 * i : 8 * i + 8], "little") for i in range(25)]
    lanes = keccak_f1600_lanes(lanes)
    out = bytearray(200)
    for i, lane in enumerate(lanes):
        out[8 * i : 8 * i + 8] = lane.to_bytes(8, "little")
    return out


# Prefer the native C extension when available (csrc/keccak.c); identical
# behaviour, ~100x faster. Falls back silently to the pure-Python version.
try:  # pragma: no cover - exercised when the extension is built
    from curdleproofs_jax._keccak_native import keccak_f1600 as _native_f1600

    def keccak_f1600(state: bytes) -> bytearray:  # noqa: F811
        return bytearray(_native_f1600(bytes(state)))

    HAS_NATIVE = True
except ImportError:  # pragma: no cover
    HAS_NATIVE = False
