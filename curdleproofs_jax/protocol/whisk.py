"""Ethereum Whisk consensus-facing byte-level API.

The interface consumed by consensus-specs test harnesses: trackers are
pairs of 48-byte BLS pubkeys, proofs are flat byte strings, and IsValid*
wrap the raising verifiers into bools. Behaviour parity:
whisk_interface.py:24-190 (transcript domains b"curdleproofs" /
b"whisk_opening_proof", identical wire layouts).

Tracker columns are decoded with ONE native batch decompression per column
instead of a per-tracker Python loop."""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, List, NewType, Optional, Sequence, Tuple

from curdleproofs_jax.curve import (
    DECOMPRESS_DEVICE_MIN,
    G1,
    G1_GENERATOR,
    compress_host_batch,
    decompress_host_batch,
)
from curdleproofs_jax.fields import Fr
from curdleproofs_jax.protocol.primitives import CurdleproofsCrs
from curdleproofs_jax.protocol.shuffle import (
    CurdleProofsProof,
    shuffle_permute_and_commit_input,
)
from curdleproofs_jax.protocol.sigma import TrackerOpeningProof
from curdleproofs_jax.protocol.wire import PT, WireStruct
from curdleproofs_jax.transcript.oracle import Transcript
from curdleproofs_jax.utils.rng import ProofRng, default_rng
from curdleproofs_jax.utils.serde import BufReader

BLSPubkey = NewType("BLSPubkey", bytes)  # 48-byte compressed G1
WhiskShuffleProofBytes = bytes
SerializedWhiskTrackerProof = bytes

_OPENING_DOMAIN = b"whisk_opening_proof"


class WhiskTracker:
    """A (r*G, k*r*G) tracker pair in compressed form."""

    __slots__ = ("r_G", "k_r_G")

    def __init__(self, r_G: BLSPubkey, k_r_G: BLSPubkey) -> None:
        self.r_G = r_G
        self.k_r_G = k_r_G


@dataclass(frozen=True)
class WhiskShuffleProof(WireStruct):
    M: G1
    proof: CurdleProofsProof

    WIRE: ClassVar = (("M", PT), ("proof", CurdleProofsProof))


def _tracker_columns(
    trackers: Sequence[WhiskTracker],
) -> Tuple[List[G1], List[G1]]:
    """Decode all r_G then all k_r_G points — two batch native calls."""
    r_blob = b"".join(t.r_G for t in trackers)
    krg_blob = b"".join(t.k_r_G for t in trackers)
    return decompress_host_batch(r_blob), decompress_host_batch(krg_blob)


def _encode_trackers(vec_T: List[G1], vec_U: List[G1]) -> List[WhiskTracker]:
    t_blob = compress_host_batch(vec_T)
    u_blob = compress_host_batch(vec_U)
    return [
        WhiskTracker(
            BLSPubkey(t_blob[48 * i : 48 * i + 48]),
            BLSPubkey(u_blob[48 * i : 48 * i + 48]),
        )
        for i in range(len(vec_T))
    ]


def GenerateWhiskShuffleProof(
    crs: CurdleproofsCrs,
    pre_shuffle_trackers: Sequence[WhiskTracker],
    rng: Optional[ProofRng] = None,
) -> Tuple[List[WhiskTracker], WhiskShuffleProofBytes]:
    """Shuffle + re-randomize the trackers and prove it; returns the
    post-shuffle trackers and the serialized proof."""
    rng = rng or default_rng()
    permutation = rng.permutation(crs.ell)
    k = rng.random_scalar()

    vec_R, vec_S = _tracker_columns(pre_shuffle_trackers)
    vec_T, vec_U, M, m_blinders = shuffle_permute_and_commit_input(
        crs, vec_R, vec_S, permutation, k, rng
    )
    proof = CurdleProofsProof.new(
        crs=crs,
        vec_R=vec_R,
        vec_S=vec_S,
        vec_T=vec_T,
        vec_U=vec_U,
        M=M,
        permutation=permutation,
        k=k,
        vec_m_blinders=m_blinders,
        rng=rng,
    )
    return _encode_trackers(vec_T, vec_U), WhiskShuffleProof(M, proof).to_bytes()


def GenerateWhiskShuffleProofs(
    crs: CurdleproofsCrs,
    pre_shuffle_tracker_lists: Sequence[Sequence[WhiskTracker]],
    rng: Optional[ProofRng] = None,
) -> List[Tuple[List[WhiskTracker], WhiskShuffleProofBytes]]:
    """Batch *proving* (framework extension; SURVEY §2.3 batch parallelism):
    K independent shuffle proofs over the same CRS. Per-proof randomness is
    derived via rng.spawn() in batch order, so a seeded rng stays
    deterministic regardless of thread scheduling. Results match K
    sequential GenerateWhiskShuffleProof calls semantically (each proof
    verifies independently).

    Two strategies (CURDLEPROOFS_BATCH_PROVE):
      * "thread" (default): a pool of independent provers on the native
        host backend, which releases the GIL — scales with host cores and
        pays zero cross-prover synchronization.
      * "lockstep": every protocol point-op coalesces across the batch
        into one merged device dispatch (utils.lockstep) — the MSMs of
        K=64 ell=124 provers become 64x128-lane ladder batches. Each of
        the protocol's hundreds of sequential steps pays one device round
        trip and one barrier across the K worker threads."""
    import os as _os

    rng = rng or default_rng()
    rngs = [rng.spawn() for _ in pre_shuffle_tracker_lists]

    def make(pre: Sequence[WhiskTracker], r: ProofRng):
        return lambda: GenerateWhiskShuffleProof(crs, pre, r)

    fns = [
        make(pre, r) for pre, r in zip(pre_shuffle_tracker_lists, rngs)
    ]
    if _os.environ.get("CURDLEPROOFS_BATCH_PROVE", "thread") == "lockstep":
        from curdleproofs_jax.utils.lockstep import run_lockstep

        return run_lockstep(fns)
    from concurrent.futures import ThreadPoolExecutor

    workers = min(8, _os.cpu_count() or 1, max(1, len(fns)))
    if workers <= 1 or len(fns) <= 1:
        return [f() for f in fns]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(lambda f: f(), fns))


def AssertIsValidWhiskShuffleProof(
    crs: CurdleproofsCrs,
    pre_shuffle_trackers: Sequence[WhiskTracker],
    post_shuffle_trackers: Sequence[WhiskTracker],
    whisk_shuffle_proof_bytes: WhiskShuffleProofBytes,
) -> None:
    vec_R, vec_S = _tracker_columns(pre_shuffle_trackers)
    vec_T, vec_U = _tracker_columns(post_shuffle_trackers)
    wrapped = WhiskShuffleProof.from_bytes(
        BufReader(whisk_shuffle_proof_bytes), crs.ell + crs.n_blinders
    )
    wrapped.proof.verify(crs, vec_R, vec_S, vec_T, vec_U, wrapped.M)


def IsValidWhiskShuffleProof(
    crs: CurdleproofsCrs,
    pre_shuffle_trackers: Sequence[WhiskTracker],
    post_shuffle_trackers: Sequence[WhiskTracker],
    whisk_shuffle_proof_bytes: WhiskShuffleProofBytes,
) -> bool:
    """bool wrapper over the raising verifier (whisk_interface.py:74-87)."""
    try:
        AssertIsValidWhiskShuffleProof(
            crs,
            pre_shuffle_trackers,
            post_shuffle_trackers,
            whisk_shuffle_proof_bytes,
        )
        return True
    except Exception:
        return False


def AreValidWhiskShuffleProofs(
    crs: CurdleproofsCrs,
    instances: Sequence[
        Tuple[Sequence[WhiskTracker], Sequence[WhiskTracker], WhiskShuffleProofBytes]
    ],
) -> bool:
    """Batched verification at the consensus byte level (framework
    extension): every proof's equations share ONE deferred MSM, so K
    epochs of shuffle proofs cost a single large multiexponentiation.
    All-or-nothing: returns False if ANY instance fails (callers that need
    blame attribution fall back to per-proof IsValidWhiskShuffleProof).

    Per-proof work (tracker decompression — a 381-bit sqrt per point —
    transcript replay, and the O(n) verification scalar math) dominates the
    batch wall once the MSM is merged, so it runs across a thread pool: the
    native decompress/MSM calls release the GIL and host cores parallelize
    them. Per-thread MSMAccumulators are folded into one final deferred MSM
    (soundness via the per-check random linear combination either way)."""
    import os as _os
    from concurrent.futures import ThreadPoolExecutor

    from curdleproofs_jax.protocol.primitives import MSMAccumulator

    try:
        n = crs.ell + crs.n_blinders

        # Decompress EVERY instance's tracker columns in one batched call
        # when the K*4*ell total reaches device scale: one dispatch of the
        # batched sqrt kernel (ops.compress) replaces K*4 native loops of
        # per-point 381-bit sqrts — the single largest per-proof cost.
        cols: Optional[List[List[G1]]] = None
        total_pts = sum(len(pre) * 2 + len(post) * 2 for pre, post, _ in instances)
        if total_pts >= DECOMPRESS_DEVICE_MIN:
            blob = b"".join(
                b"".join(t.r_G for t in pre)
                + b"".join(t.k_r_G for t in pre)
                + b"".join(t.r_G for t in post)
                + b"".join(t.k_r_G for t in post)
                for pre, post, _ in instances
            )
            flat = decompress_host_batch(blob)
            cols = []
            off = 0
            for pre, post, _ in instances:
                lp, lq = len(pre), len(post)
                cols.append(
                    [
                        flat[off : off + lp],
                        flat[off + lp : off + 2 * lp],
                        flat[off + 2 * lp : off + 2 * lp + lq],
                        flat[off + 2 * lp + lq : off + 2 * lp + 2 * lq],
                    ]
                )
                off += 2 * lp + 2 * lq

        def check_one(idx_inst):
            idx, (pre, post, proof_bytes) = idx_inst
            local = MSMAccumulator()
            if cols is not None:
                vec_R, vec_S, vec_T, vec_U = cols[idx]
            else:
                vec_R, vec_S = _tracker_columns(pre)
                vec_T, vec_U = _tracker_columns(post)
            wrapped = WhiskShuffleProof.from_bytes(BufReader(proof_bytes), n)
            wrapped.proof.verify(
                crs, vec_R, vec_S, vec_T, vec_U, wrapped.M,
                msm_accumulator=local,
            )
            return local

        workers = min(8, _os.cpu_count() or 1, max(1, len(instances)))
        if workers > 1 and len(instances) > 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                locals_ = list(pool.map(check_one, enumerate(instances)))
        else:
            locals_ = [check_one(i) for i in enumerate(instances)]
        acc = MSMAccumulator()
        for local in locals_:
            acc.absorb(local)
        acc.verify()
        return True
    except Exception:
        return False


def GenerateWhiskTrackerProof(
    tracker: WhiskTracker,
    k: Fr,
    rng: Optional[ProofRng] = None,
) -> SerializedWhiskTrackerProof:
    """Prove knowledge of k binding the tracker to k*G (128 bytes)."""
    r_G = G1.from_compressed_bytes_unchecked(tracker.r_G)
    proof = TrackerOpeningProof.new(
        k_r_G=G1.from_compressed_bytes_unchecked(tracker.k_r_G),
        r_G=r_G,
        k_G=G1_GENERATOR * k,
        k=k,
        transcript=Transcript(_OPENING_DOMAIN),
        rng=rng,
    )
    return proof.to_bytes()


def AssertIsValidWhiskOpeningProof(
    tracker: WhiskTracker,
    k_commitment: BLSPubkey,
    tracker_proof: SerializedWhiskTrackerProof,
) -> None:
    proof = TrackerOpeningProof.from_bytes(BufReader(tracker_proof))
    proof.verify(
        Transcript(_OPENING_DOMAIN),
        G1.from_compressed_bytes_unchecked(tracker.k_r_G),
        G1.from_compressed_bytes_unchecked(tracker.r_G),
        G1.from_compressed_bytes_unchecked(k_commitment),
    )


def IsValidWhiskOpeningProof(
    tracker: WhiskTracker,
    k_commitment: BLSPubkey,
    tracker_proof: SerializedWhiskTrackerProof,
) -> bool:
    try:
        AssertIsValidWhiskOpeningProof(tracker, k_commitment, tracker_proof)
        return True
    except Exception:
        return False
