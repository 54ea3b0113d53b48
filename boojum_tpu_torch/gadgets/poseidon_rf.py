"""The legacy Poseidon circuit round function and sponge of the JAX
package's gadgets/poseidon_rf.py (era-boojum gadgets/poseidon/mod.rs over
the flattened legacy gate, poseidon.rs:1249): the sponge of
poseidon2_rf.py on the legacy permutation, hashing as the host
`PoseidonSpongeHost` does, so a recursion circuit replays the challenges of
a `ProofConfig(transcript="poseidon")` proof."""

from __future__ import annotations

from ..cs.gates.poseidon_flat import PoseidonFlattenedGate
from .poseidon2_rf import CAPACITY, RATE, CircuitSponge

__all__ = ["CAPACITY", "RATE", "CircuitPoseidonSponge", "circuit_hash_leaf",
           "circuit_hash_node", "circuit_permutation"]


def circuit_permutation(cs, state_vars):
    """One width-12 legacy Poseidon permutation over circuit variables."""
    return PoseidonFlattenedGate.permutation(cs, state_vars)


class CircuitPoseidonSponge(CircuitSponge):
    permutation = staticmethod(circuit_permutation)


def circuit_hash_leaf(cs, variables, n=CAPACITY):
    return CircuitPoseidonSponge.hash_leaf(cs, variables, n)


def circuit_hash_node(cs, left, right):
    return CircuitPoseidonSponge.hash_node(cs, left, right)
