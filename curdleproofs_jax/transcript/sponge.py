"""Keccak sponge constructions (SHAKE / SHA3) over keccak_f1600.

Not used by the proof system itself — STROBE drives the permutation directly
— but part of the transcript package surface for parity with the reference's
keccak module (merlin_transcripts/keccak.py:69-123) and useful for test
vector generation. Validated against hashlib in tests.
"""
from __future__ import annotations

from curdleproofs_jax.transcript.keccak import keccak_f1600


def keccak_sponge(
    rate_bits: int, capacity_bits: int, data: bytes, suffix: int, out_len: int
) -> bytes:
    if rate_bits + capacity_bits != 1600 or rate_bits % 8:
        raise ValueError("invalid rate/capacity")
    rate = rate_bits // 8
    state = bytearray(200)

    # absorb
    off = 0
    block = 0
    while off < len(data):
        take = min(rate - block, len(data) - off)
        for i in range(take):
            state[block + i] ^= data[off + i]
        off += take
        block += take
        if block == rate:
            state = keccak_f1600(state)
            block = 0
    # pad + domain suffix
    state[block] ^= suffix
    if suffix & 0x80 and block == rate - 1:
        state = keccak_f1600(state)
    state[rate - 1] ^= 0x80
    state = keccak_f1600(state)

    # squeeze
    out = bytearray()
    while len(out) < out_len:
        take = min(out_len - len(out), rate)
        out += state[:take]
        if len(out) < out_len:
            state = keccak_f1600(state)
    return bytes(out)


def shake128(data: bytes, out_len: int) -> bytes:
    return keccak_sponge(1344, 256, data, 0x1F, out_len)


def shake256(data: bytes, out_len: int) -> bytes:
    return keccak_sponge(1088, 512, data, 0x1F, out_len)


def sha3_224(data: bytes) -> bytes:
    return keccak_sponge(1152, 448, data, 0x06, 28)


def sha3_256(data: bytes) -> bytes:
    return keccak_sponge(1088, 512, data, 0x06, 32)


def sha3_384(data: bytes) -> bytes:
    return keccak_sponge(832, 768, data, 0x06, 48)


def sha3_512(data: bytes) -> bytes:
    return keccak_sponge(576, 1024, data, 0x06, 64)
