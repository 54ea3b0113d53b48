"""The Fiat-Shamir transcript inside a circuit, as in the JAX package's
gadgets/recursion/transcript.py (era-boojum recursive_transcript.rs): the
host transcript's sponge (transcript.py, overwrite absorption, a trailing 1
as padding) over circuit variables, through a flattened permutation gate,
so the recursion circuit draws the prover's challenges.

Query-index bits follow the host `BitSource`: each challenge is split into
64 boolean bits with a canonicity constraint (the high 32 bits all ones
force the low 32 bits to zero: p = 2^64 - 2^32 + 1 makes that the only
non-canonical encoding), and the low `64 - max_needed` bits of each are
used.
"""

from __future__ import annotations

from ...cs.gates.simple import BooleanConstraintGate, FmaGate, ReductionGate
from ..chunk_utils import enforce_chunk_recomposition
from ..poseidon2_rf import circuit_permutation


class CircuitTranscript:
    def __init__(self, cs, permutation=None):
        """`permutation`: the round function in the circuit, the flattened
        Poseidon2 gate's by default, or the legacy Poseidon one
        (gadgets/poseidon_rf.py) for a `transcript="poseidon"` proof."""
        self.cs = cs
        self._perm = permutation or circuit_permutation
        self.state = [cs.zero_var()] * 12
        self.buffer: list = []
        self.available: list = []

    def witness_field_elements(self, variables):
        self.buffer.extend(variables)

    def witness_merkle_tree_cap(self, cap_digest_vars):
        for digest in cap_digest_vars:
            self.witness_field_elements(list(digest))

    def get_challenge(self):
        if not self.buffer:
            if not self.available:
                self.state = self._perm(self.cs, self.state)
                self.available = list(self.state[:8])
            return self.available.pop(0)
        to_absorb = self.buffer + [self.cs.one_var()]
        self.buffer = []
        zero = self.cs.zero_var()
        while len(to_absorb) % 8:
            to_absorb.append(zero)
        for i in range(0, len(to_absorb), 8):
            self.state = self._perm(self.cs, to_absorb[i : i + 8] + self.state[8:])
        self.available = list(self.state[:8])
        return self.available.pop(0)

    def get_multiple_challenges(self, n: int):
        return [self.get_challenge() for _ in range(n)]

    def get_ext_challenge(self):
        return (self.get_challenge(), self.get_challenge())


def decompose_challenge_canonical(cs, c_var):
    """The 64 little-endian boolean bit variables of a challenge, with the
    canonical-encoding constraint."""
    bits = cs.alloc_multiple_variables_without_values(64)
    cs.set_values_with_dependencies([c_var], bits,
                                    lambda vals: [(vals[0] >> i) & 1 for i in range(64)])
    for b in bits:
        BooleanConstraintGate.enforce(cs, b)
    enforce_chunk_recomposition(cs, bits, c_var, bits_per_chunk=1)  # Σ b_i 2^i = c
    # canonical: AND(high 32 bits) · (the low 32 bits recomposed) = 0
    high_and = bits[32]
    for b in bits[33:]:
        high_and = FmaGate.fma(cs, high_and, b, cs.zero_var(), 1, 0)
    low_acc = None
    shift = 0
    rem = list(bits[:32])
    while rem:
        chunk, rem = rem[:3], rem[3:]
        vars4, cf = [], []
        if low_acc is not None:
            vars4.append(low_acc)
            cf.append(1)
        for b in chunk:
            vars4.append(b)
            cf.append(1 << shift)
            shift += 1
        while len(vars4) < 4:
            vars4.append(cs.zero_var())
            cf.append(0)
        low_acc = ReductionGate.reduce(cs, vars4, cf)
    FmaGate.enforce_fma(cs, high_and, low_acc, cs.zero_var(), cs.zero_var(), 1, 0)
    return bits


class CircuitBitSource:
    """The host BitSource in a circuit: boolean bit variables from canonical
    challenge decompositions."""

    def __init__(self, cs, max_needed_bits: int):
        assert 0 < max_needed_bits < 64
        self.cs = cs
        self.bits: list = []
        self.max_needed = max_needed_bits

    def get_bits(self, transcript: CircuitTranscript, num_bits: int):
        while len(self.bits) < num_bits:
            all_bits = decompose_challenge_canonical(self.cs, transcript.get_challenge())
            self.bits.extend(all_bits[: 64 - self.max_needed])
        out, self.bits = self.bits[:num_bits], self.bits[num_bits:]
        return out

    def get_index_bits(self, transcript: CircuitTranscript, num_bits: int):
        """The little-endian boolean bit variables of one query index."""
        return self.get_bits(transcript, num_bits)
