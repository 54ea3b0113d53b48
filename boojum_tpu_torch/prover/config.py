"""Proof configuration (era-boojum ProofConfig), as in the JAX package."""

from dataclasses import dataclass


@dataclass
class ProofConfig:
    fri_lde_factor: int = 8
    merkle_tree_cap_size: int = 16
    num_queries: int = 50
    pow_bits: int = 0
    fri_final_degree: int = 64  # stop folding when the degree is <= this
    # the folds of each committed FRI oracle (2^k to 1 each); None: greedy
    # 3s, then the remainder (fri.fold_schedule)
    fri_folding_schedule: list | None = None
    # the quotient's coset count, the rate of the sweep; None derives it
    # from the constraint degrees at setup. It is independent of
    # fri_lde_factor, the rate the oracles commit at.
    quotient_degree: int | None = None
    # the Fiat-Shamir transcript (transcript.TRANSCRIPTS); the tree hasher
    # stays Poseidon2 whatever it is
    transcript: str = "poseidon2"

    def __post_init__(self):
        from ..transcript import checked_transcript

        def pow2(x):
            return x >= 1 and x & (x - 1) == 0

        if not pow2(self.fri_lde_factor) or not pow2(self.merkle_tree_cap_size):
            raise ValueError("fri_lde_factor and cap size must be powers of two")
        if self.fri_folding_schedule is not None and not all(
                int(k) >= 1 for k in self.fri_folding_schedule):
            raise ValueError(f"folding schedule {self.fri_folding_schedule}: every entry "
                             f"folds at least once")
        if self.quotient_degree is not None and not pow2(self.quotient_degree):
            raise ValueError("quotient_degree must be a power of two")
        checked_transcript(self.transcript)
