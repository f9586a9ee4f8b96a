"""External golden-vector anchoring of the curve arithmetic.

The reference inherits battle-tested group math from the arkworks wheel
(test_curdleproofs.py:45-213); this repo implements BLS12-381 from scratch
three times (exact host ints, native C Montgomery, device limb kernels), and
the round-3 interop test injected OUR host backend into the reference — so
a consistent arithmetic bug could have passed everywhere.

Anchor: `_indep_*` below is a FOURTH implementation written from first
principles against the published curve parameters in DECIMAL (q, r, b = 4,
generator affine coordinates) with affine chord-tangent formulas and
Fermat inversion via pow(., -1, q) — no code, constants, representation
(no Montgomery, no limbs, no Jacobian) or formulas shared with the package.
The KG_VECTORS / MSM* constants were generated with it
(benchmarks/_gen_golden.py) and are frozen here; the tests assert that the
independent implementation still reproduces them AND that every package
path (host G1, native batch ops, device pack/ladder/stream MSM, batched
serde) agrees. k=1 equals the standard generator encoding pinned by the
reference (test_curdleproofs.py:179-180), k=2 the widely published 2G.
"""
import numpy as np
import pytest

from curdleproofs_jax.curve import (
    G1,
    compress_host_batch,
    decompress_host_batch,
    msm_host,
    mul_host_batch,
)
from curdleproofs_jax.fields import FQ_MOD, FR_MOD, Fr

# ---- independent implementation (generator of record) ----------------------

_Q = 4002409555221667393417789825735904156556882819939007885332058136124031650490837864442687629129015664037894272559787
_R = 52435875175126190479447740508185965837690552500527637822603658699938581184513
_GX = 3685416753713387016781088315183077757961620795782546409894578378688607592378376318836054947676345821548104185464507
_GY = 1339506544944476473020471379941921221584933875938349620426543736416511423956333506472724655353366534992391756441569


def _indep_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % _Q == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, -1, _Q) % _Q
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, _Q) % _Q
    x3 = (lam * lam - x1 - x2) % _Q
    y3 = (lam * (x1 - x3) - y1) % _Q
    return (x3, y3)


def _indep_mul(p, k):
    acc = None
    while k:
        if k & 1:
            acc = _indep_add(acc, p)
        p = _indep_add(p, p)
        k >>= 1
    return acc


def _indep_compress(p):
    if p is None:
        return bytes([0xC0]) + bytes(47)
    x, y = p
    b = bytearray(x.to_bytes(48, "big"))
    b[0] |= 0x80
    if y > (_Q - 1) // 2:
        b[0] |= 0x20
    return bytes(b)


# ---- frozen vectors (benchmarks/_gen_golden.py) ----------------------------

KG_VECTORS = [
    (0x1, "97f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac586c55e83ff97a1aeffb3af00adb22c6bb"),
    (0x2, "a572cbea904d67468808c8eb50a9450c9721db309128012543902d0ac358a62ae28f75bb8f1c7c42c39a8c5529bf0f4e"),
    (0x3, "89ece308f9d1f0131765212deca99697b112d61f9be9a5f1f3780a51335b3ff981747a0b2ca2179b96d2c0c9024e5224"),
    (0x4, "ac9b60d5afcbd5663a8a44b7c5a02f19e9a77ab0a35bd65809bb5c67ec582c897feb04decc694b13e08587f3ff9b5b60"),
    (0x5, "b0e7791fb972fe014159aa33a98622da3cdc98ff707965e536d8636b5fcc5ac7a91a8c46e59a00dca575af0f18fb13dc"),
    (0x7, "b928f3beb93519eecf0145da903b40a4c97dca00b21f12ac0df3be9116ef2ef27b2ae6bcd4c5bc2d54ef5a70627efcb7"),
    (0x8, "a85ae765588126f5e860d019c0e26235f567a9c0c0b2d8ff30f3e8d436b1082596e5e7462d20f5be3764fd473e57f9cf"),
    (0xFF, "97e827da16cbd1da013b125a96b24770e0cad7e5af0ccd9fb75a60d8ba426891489d44497b091e1b0383f457f1b2251c"),
    (0x100, "8025cdadf2afc5906b2602574a799f4089d90f36d73f94c1cf317cfc1a207c57f232bca6057924dd34cff5bde87f1930"),
    (0x10001, "88cab01b6d06a323e18f50141a694e7e71ab18ffdfab536a45ccf0b49a634ee82d00750e9f4c15d806c33a8950664d7f"),
    (0x10000000000000000, "814857e17b2a0eaa5aa6e4f7fc894c8437bd537efb294e79fd253ec4d3fbe3b3d10f142e687325506111f54e8c78162c"),
    (0x100000000000000000000000000000000, "a1bf5306c66b2a7a583e7c573146ff639ab1000beb9f86c3d0a7e79b3009884d2cf15d868e7f0d3af1c43c35ffa3097f"),
    (0x1000000000000000000000000000000000000000000000000, "854176e8cadd89461af2e044a47da9bc5646ab24a3204dd16a5f1e3315b39b88b26cc1d552d01a0b8d1bc26d8570646d"),
    (0x4000000000000000000000000000000000000000000000000000000000000000, "876072f7a9319cd7dca9f2d4dcb26a17acb8a245eacf79e0c783938afb7689d64744e713946e0505a3031f047cf133fc"),
    (_R - 1, "b7f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac586c55e83ff97a1aeffb3af00adb22c6bb"),
    (_R - 2, "8572cbea904d67468808c8eb50a9450c9721db309128012543902d0ac358a62ae28f75bb8f1c7c42c39a8c5529bf0f4e"),
    ((_R - 1) // 2, "87726dc031bd26122395153ca428d5e6dea0a64c1f9b3b1bb2f2508a5eb6ea0ea0363294fad3160858bc87e46d3422fd"),
    ((_R + 1) // 2, "a7726dc031bd26122395153ca428d5e6dea0a64c1f9b3b1bb2f2508a5eb6ea0ea0363294fad3160858bc87e46d3422fd"),
    (0xAC45A4010001A40200000000FFFFFFFF, "88dc871d10797b5a25bde7201bbfa0785d137ce284469115be39e624c5fa86c95c11019fdc94281f53de9bf71abf187b"),
    (0xAC45A4010001A4020000000100000000, "b333c91030ee7a4649e404c01b2e0d26a8728dd7cb4edb636ed984de104bb92674f1161d8c99bcf024e473fe0a1d7620"),
    (0x6AC0179CA1613D75DEFA7E708709F5E9BC3027A68766E722AABBCCDEEEFF0010, "81ccb739a277f297f9413e326ee3bf06513554ac7adad5bd5b4cd31d356224af09e300ffffec14c0d183deaaa2ee995c"),
    (0x1FF00FF00FF00FF00FF00FF00FF00FF00FF00FF00FF00FF00FF00FF00FF00FF, "b0f1777d1c9b6de0a5ea6d03d611face090d4e1dd94e232affa67e9dab1e06dbbaff76959cffa4a76961239a207f1c95"),
]

MSM8_SCALARS = [3, 1, 4, 1, 5, 9, 2, 6]
MSM8 = "b43dc65ed3a3cca3400886264d7b5bae83ef60ecb82e1195902090020a0e57d16df36a05a90b05a2f9a6e968ea08a79f"
MSM8_BIG_SCALARS = [_R - 1, _R - 2, 2**200 % _R, 1, 0, 12345, 2**254 % _R, 7]
MSM8_BIG = "937de9e7326e9289ac862380b4ffd512c22cfa89d6134e387e020e53f62c59cae0b4e8637a475ef66dd0cf659149fe65"
SUM_ALL = "813f300ded72c65b0191f9d54424440acdc5ea926a43be8d02e047be31f74934708ae730e4d316586928ffb12ea1672f"

P5_XY = (
    2601793266141653880357945339922727723793268013331457916525213050197274797722760296318099993752923714935161798464476,
    3498096627312022583321348410616510759186251088555060790999813363211667535344132702692445545590448314959259020805858,
)


def test_independent_impl_reproduces_frozen_vectors():
    """The generator-of-record still produces the frozen constants (guards
    against accidental edits to either side)."""
    g = (_GX, _GY)
    for k, hexenc in KG_VECTORS[:6] + KG_VECTORS[-3:]:
        assert _indep_compress(_indep_mul(g, k)).hex() == hexenc
    acc = None
    for (k, _), s in zip(KG_VECTORS[:8], MSM8_SCALARS):
        acc = _indep_add(acc, _indep_mul(g, k * s))
    assert _indep_compress(acc).hex() == MSM8


def test_host_scalar_mul_matches_golden():
    g = G1()
    for k, hexenc in KG_VECTORS:
        assert (g * Fr(k)).to_compressed_bytes().hex() == hexenc, hex(k)


def test_native_batch_mul_and_compress_match_golden():
    ks = [Fr(k) for k, _ in KG_VECTORS]
    pts = mul_host_batch([G1()] * len(ks), ks)
    blob = compress_host_batch(pts)
    for i, (_, hexenc) in enumerate(KG_VECTORS):
        assert blob[48 * i : 48 * i + 48].hex() == hexenc


def test_msm_all_engines_match_golden():
    from curdleproofs_jax.ops import g1 as og
    from curdleproofs_jax.ops import msm as omsm
    from curdleproofs_jax.ops.fieldspec import ints_to_limbs

    bases = [G1() * Fr(k) for k, _ in KG_VECTORS[:8]]
    for scalars, want_hex in (
        (MSM8_SCALARS, MSM8),
        (MSM8_BIG_SCALARS, MSM8_BIG),
    ):
        frs = [Fr(s) for s in scalars]
        assert msm_host(bases, frs).to_compressed_bytes().hex() == want_hex
        pts = og.pack_points(bases)
        scs = og.pack_scalars(frs)
        got = omsm.msm_pippenger(pts, scs, c=8)
        assert got.to_compressed_bytes().hex() == want_hex
        sc_np = np.asarray(
            ints_to_limbs([f.v for f in frs], 16), dtype=np.uint32
        )
        got = omsm.msm_pippenger_stream(pts, sc_np, c=8)
        assert got.to_compressed_bytes().hex() == want_hex
    # sum of every k*G vector: plain adds across unrelated points
    acc = G1.identity()
    for k, _ in KG_VECTORS:
        acc = acc + G1() * Fr(k)
    assert acc.to_compressed_bytes().hex() == SUM_ALL


def test_decompression_matches_golden_affine():
    # checked + unchecked host paths, against independent affine coords
    enc5 = bytes.fromhex(KG_VECTORS[4][1])  # 5*G
    for dec in (G1.from_compressed_bytes, G1.from_compressed_bytes_unchecked):
        p = dec(enc5)
        assert (p.x, p.y) == P5_XY
    # sign flip decodes to the negation
    flipped = bytearray(enc5)
    flipped[0] ^= 0x20
    pneg = G1.from_compressed_bytes_unchecked(bytes(flipped))
    assert (pneg.x, pneg.y) == (P5_XY[0], FQ_MOD - P5_XY[1])
    # batched native decode of the full table
    blob = b"".join(bytes.fromhex(h) for _, h in KG_VECTORS)
    pts = decompress_host_batch(blob)
    g = G1()
    for (k, _), p in zip(KG_VECTORS, pts):
        assert p == g * Fr(k)
    # device batched decode (ops.compress twin)
    from curdleproofs_jax.ops import compress as ocompress

    dev_pts = ocompress.batch_decompress_to_host(
        [bytes.fromhex(h) for _, h in KG_VECTORS]
    )
    for (k, _), p in zip(KG_VECTORS, dev_pts):
        assert p == g * Fr(k)


def test_device_ladder_matches_golden(monkeypatch):
    """Device scalar-mul path (the GLV ladder program, one 8-lane tile)
    against the independent vectors."""
    from curdleproofs_jax.ops import g1 as og
    from curdleproofs_jax.ops import msm as omsm

    monkeypatch.setattr(og, "GLV_TILE", 8)

    ks = [k for k, _ in KG_VECTORS[:6]] + [_R - 1, (_R + 1) // 2]
    # one ladder MSM per scalar against a one-hot selection would be slow;
    # instead check sum(k_i * G) == independent sum via the ladder engine
    bases = [G1()] * len(ks)
    got = omsm.msm_ladder(
        og.pack_points(bases), og.pack_scalars([Fr(k) for k in ks])
    )
    g = (_GX, _GY)
    acc = None
    for k in ks:
        acc = _indep_add(acc, _indep_mul(g, k))
    assert got.to_compressed_bytes().hex() == _indep_compress(acc).hex()


def test_curve_constants_match_published_decimals():
    """The package's hex-derived field/group constants equal the published
    decimal parameters used by the independent implementation."""
    assert FQ_MOD == _Q
    assert FR_MOD == _R
    g = G1()
    assert (g.x, g.y) == (_GX, _GY)
