"""Injectable randomness for blinders and permutations.

The reference samples blinders with the stdlib `random` module
(util.py:21-24, whisk_interface.py:114-116). We default to the same
distributional behaviour but route everything through a ProofRng object so
tests can fix seeds and produce deterministic proofs (needed for
cross-implementation test vectors — SURVEY.md §7.6)."""
from __future__ import annotations

import random
from typing import List, Optional

from curdleproofs_jax.fields import FR_MOD, Fr


class ProofRng:
    def __init__(self, seed: Optional[int] = None) -> None:
        self._rng = random.Random(seed) if seed is not None else random.SystemRandom()

    def random_scalar(self) -> Fr:
        """Uniform nonzero scalar (reference util.py:21-24 samples [1, r-1])."""
        return Fr(self._rng.randint(1, FR_MOD - 1))

    def blinders(self, n: int) -> List[Fr]:
        return [self.random_scalar() for _ in range(n)]

    def permutation(self, n: int) -> List[int]:
        perm = list(range(n))
        self._rng.shuffle(perm)
        return perm

    def spawn(self) -> "ProofRng":
        """Derive an independent child rng.

        Drawing the child seed happens HERE, on the caller's thread, so a
        batch of children can be derived sequentially and then handed to a
        thread pool — each worker owns its rng, keeping seeded runs
        deterministic regardless of thread interleaving."""
        return ProofRng(self._rng.getrandbits(128))


_default = ProofRng()


def default_rng() -> ProofRng:
    return _default
