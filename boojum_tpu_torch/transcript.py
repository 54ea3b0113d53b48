"""Fiat-Shamir transcript over the Poseidon2 sponge (host side).

Algebraic sponge transcript with overwrite absorption and rescue-prime
padding (a trailing 1), and the query-index bit source that takes only the
low bits of each challenge, as era-boojum's transcript.rs and the JAX
package's transcript.py do. Everything it absorbs is read back from the
device once per round.
"""

from .field import gl
from .hashes.poseidon2 import poseidon2_permutation_host

RATE = 8
WIDTH = 12
CHALLENGE_BITS = 64


class Poseidon2Transcript:
    def __init__(self):
        self.state = [0] * WIDTH
        self.buffer = []
        self.available = []

    def witness_field_elements(self, els):
        self.buffer.extend(int(e) % gl.P for e in els)

    def witness_merkle_tree_cap(self, cap):
        for digest in cap:
            self.witness_field_elements(digest)

    def get_challenge(self) -> int:
        if not self.buffer:
            if self.available:
                return self.available.pop(0)
            self.state = poseidon2_permutation_host(self.state)
            self.available = list(self.state[:RATE])
            return self.available.pop(0)
        # rescue-prime padding: trailing 1, then zeros to a multiple of rate
        to_absorb = self.buffer + [1]
        self.buffer = []
        while len(to_absorb) % RATE:
            to_absorb.append(0)
        for i in range(0, len(to_absorb), RATE):
            self.state[:RATE] = to_absorb[i : i + RATE]
            self.state = poseidon2_permutation_host(self.state)
        self.available = list(self.state[:RATE])
        return self.available.pop(0)

    def get_multiple_challenges(self, n: int):
        return [self.get_challenge() for _ in range(n)]

    def get_ext_challenge(self):
        """One challenge per GF(p^2) coordinate."""
        return (self.get_challenge(), self.get_challenge())


class BitSource:
    """Uniform query-index bits from transcript challenges: only the low
    (64 - max_needed_bits) bits of each challenge are used."""

    def __init__(self, max_needed_bits: int):
        if not 0 < max_needed_bits < CHALLENGE_BITS:
            raise ValueError(f"max_needed_bits {max_needed_bits} out of range")
        self.bits = []
        self.max_needed = max_needed_bits

    def get_bits(self, transcript, num_bits: int):
        while len(self.bits) < num_bits:
            c = transcript.get_challenge()
            usable = CHALLENGE_BITS - self.max_needed
            self.bits.extend((c >> i) & 1 for i in range(usable))
        out, self.bits = self.bits[:num_bits], self.bits[num_bits:]
        return out

    def get_index(self, transcript, num_bits: int) -> int:
        idx = 0
        for i, b in enumerate(self.get_bits(transcript, num_bits)):
            idx |= b << i
        return idx
