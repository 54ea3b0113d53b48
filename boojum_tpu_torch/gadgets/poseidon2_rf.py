"""The Poseidon2 circuit round function and sponge of the JAX package's
gadgets/poseidon2_rf.py (era-boojum gadgets/poseidon2/mod.rs, the generic
algebraic sponge of algebraic_props/sponge.rs): rate 8, capacity 4,
overwrite mode, over circuit variables, one flattened-gate instance a
permutation. It hashes as the host sponge (hashes/poseidon2.py
`Poseidon2SpongeHost`) does, so a recursion circuit's transcript and Merkle
paths hash as the prover's."""

from __future__ import annotations

from ..cs.gates.poseidon2_flat import SW, Poseidon2FlattenedGate

RATE = 8
CAPACITY = 4


def circuit_permutation(cs, state_vars):
    """One width-12 permutation over circuit variables."""
    return Poseidon2FlattenedGate.permutation(cs, state_vars)


class CircuitSponge:
    """Overwrite-mode sponge over circuit variables, on the round function
    `permutation` (absorb order of the host sponge)."""

    permutation = staticmethod(circuit_permutation)

    def __init__(self, cs):
        self.cs = cs
        self.state = [cs.zero_var()] * SW
        self.buffer: list = []

    def absorb(self, variables):
        self.buffer.extend(variables)
        while len(self.buffer) >= RATE:
            chunk, self.buffer = self.buffer[:RATE], self.buffer[RATE:]
            self.state = self.permutation(self.cs, chunk + self.state[RATE:])

    def finalize(self, n=CAPACITY):
        if self.buffer:
            pad = [self.cs.zero_var()] * (RATE - len(self.buffer))
            self.state = self.permutation(self.cs, self.buffer + pad + self.state[RATE:])
            self.buffer = []
        return self.state[:n]

    @classmethod
    def hash_leaf(cls, cs, variables, n=CAPACITY):
        sp = cls(cs)
        sp.absorb(list(variables))
        return sp.finalize(n)

    @classmethod
    def hash_node(cls, cs, left, right):
        return cls.hash_leaf(cs, list(left) + list(right))


class CircuitPoseidon2Sponge(CircuitSponge):
    pass


def circuit_hash_leaf(cs, variables, n=CAPACITY):
    return CircuitPoseidon2Sponge.hash_leaf(cs, variables, n)


def circuit_hash_node(cs, left, right):
    return CircuitPoseidon2Sponge.hash_node(cs, left, right)
