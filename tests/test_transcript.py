"""Transcript layer golden-vector and behaviour tests.

The hex vectors are the public conformance vectors from the Rust merlin
crate's own test suite (the same vectors the reference pins in
merlin_transcripts/test_merlin.py:5-41), guaranteeing bit-equivalence with
the Rust implementation used by curdleproofs.
"""
import pytest

from curdleproofs_jax.fields import FR_MOD, Fr
from curdleproofs_jax.transcript import (
    CurdleproofsTranscript,
    MerlinTranscript,
    Strobe128,
    keccak_f1600,
)


def test_keccak_f1600_known_vector():
    # Keccak-f[1600] applied to the zero state: first lane of the standard
    # public test vector (from the Keccak team's KAT for the permutation).
    out = keccak_f1600(bytes(200))
    lane0 = int.from_bytes(out[:8], "little")
    assert lane0 == 0xF1258F7940E1DDE7
    lane1 = int.from_bytes(out[8:16], "little")
    assert lane1 == 0x84D5CCF933C0478A


def test_keccak_f1600_involution_sanity():
    # permutation is deterministic and state-size preserving
    st = bytes(range(200))
    a = keccak_f1600(st)
    b = keccak_f1600(st)
    assert a == b and len(a) == 200 and a != st


def test_strobe_conformance():
    s = Strobe128(b"Conformance Test Protocol")
    msg = bytes([99]) * 1024

    s.meta_ad(b"ms", False)
    s.meta_ad(b"g", True)
    s.ad(msg, False)

    s.meta_ad(b"prf", False)
    prf = s.prf(32, False)
    assert prf.hex() == "b48e645ca17c667fd5206ba57a6a228d72d8e1903814d3f17f622996d7cfefb0"

    s.meta_ad(b"key", False)
    s.key(bytes(prf), False)

    s.meta_ad(b"prf", False)
    prf = s.prf(32, False)
    assert prf.hex() == "07e45cce8078cee259e3e375bb85d75610e2d1e1201c5f645045a194edd49ff8"


def test_strobe_flag_mismatch_rejected():
    s = Strobe128(b"proto")
    s.meta_ad(b"a", False)
    with pytest.raises(ValueError):
        s.ad(b"b", True)  # continuation with different flags


def test_merlin_conformance():
    t = MerlinTranscript(b"test protocol")
    t.append_message(b"some label", b"some data")
    challenge = t.challenge_bytes(b"challenge", 32)
    assert (
        challenge.hex()
        == "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615"
    )


def test_merlin_chunked_absorb_equivalence():
    # bulk absorb must match many small absorbs (rate-boundary handling)
    t1 = MerlinTranscript(b"chunks")
    t1.append_message(b"m", bytes(range(256)) * 3)
    t2 = MerlinTranscript(b"chunks")
    t2.append_message(b"m", bytes(bytes(range(256)) * 3))
    assert t1.challenge_bytes(b"c", 64) == t2.challenge_bytes(b"c", 64)


def test_challenge_scalar_in_range_and_deterministic():
    t1 = CurdleproofsTranscript(b"curdleproofs")
    t1.append(b"lbl", b"payload")
    c1 = t1.get_and_append_challenge(b"chal")
    t2 = CurdleproofsTranscript(b"curdleproofs")
    t2.append(b"lbl", b"payload")
    c2 = t2.get_and_append_challenge(b"chal")
    assert isinstance(c1, Fr)
    assert c1 == c2
    assert 0 < c1.v < FR_MOD
    # appending the accepted bytes changes subsequent challenges
    assert t1.get_and_append_challenge(b"chal") != c1


def test_challenge_stream_differs_by_label_and_content():
    base = CurdleproofsTranscript(b"curdleproofs")
    base.append(b"x", b"1")
    a = base.get_and_append_challenge(b"c1")

    other = CurdleproofsTranscript(b"curdleproofs")
    other.append(b"x", b"2")
    b = other.get_and_append_challenge(b"c1")
    assert a != b


def test_sponge_constructions_vs_hashlib():
    import hashlib

    from curdleproofs_jax.transcript import sponge

    for data in (b"", b"abc", bytes(range(200)) * 2):
        assert sponge.sha3_256(data) == hashlib.sha3_256(data).digest()
        assert sponge.sha3_224(data) == hashlib.sha3_224(data).digest()
        assert sponge.sha3_384(data) == hashlib.sha3_384(data).digest()
        assert sponge.sha3_512(data) == hashlib.sha3_512(data).digest()
        assert sponge.shake128(data, 64) == hashlib.shake_128(data).digest(64)
        assert sponge.shake256(data, 200) == hashlib.shake_256(data).digest(200)


def test_native_transcript_matches_python_twin(monkeypatch):
    """The C merlin/STROBE engine vs the pure-Python Strobe128 path on a
    mixed op sequence (writes, batch writes, byte reads, rejection-sampled
    scalar draws) — transcripts must be bit-identical."""
    import curdleproofs_jax.transcript.oracle as om

    if not om._NATIVE:
        import pytest

        pytest.skip("native transcript not built")

    def drive(T):
        t = T(b"equiv-test")
        t.absorb(b"m", b"hello", b"world" * 40)
        t.absorb_u64(b"u", 0xDEADBEEF)
        out = [t.squeeze_bytes(b"c", 7), t.squeeze_bytes(b"c", 200)]
        out += [s.v for s in t.scalars(b"vec", 40)]
        t.absorb(b"m2", b"x" * 166)  # exactly one rate block
        out.append(t.squeeze_bytes(b"c2", 32))
        out.append(t.scalar(b"one").v)
        return out

    native = drive(om.Transcript)
    monkeypatch.setattr(om, "_NATIVE", False)

    class PyTranscript(om.Transcript):
        pass

    py = drive(PyTranscript)
    assert native == py
