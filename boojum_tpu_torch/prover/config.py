"""Proof configuration (era-boojum ProofConfig), as in the JAX package."""

from dataclasses import dataclass


@dataclass
class ProofConfig:
    fri_lde_factor: int = 8
    merkle_tree_cap_size: int = 16
    num_queries: int = 50
    pow_bits: int = 0
    fri_final_degree: int = 64  # stop folding when the degree is <= this

    def __post_init__(self):
        def pow2(x):
            return x >= 1 and x & (x - 1) == 0

        if not pow2(self.fri_lde_factor) or not pow2(self.merkle_tree_cap_size):
            raise ValueError("fri_lde_factor and cap size must be powers of two")
