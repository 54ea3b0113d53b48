"""Fiat-Shamir transcript over the Poseidon2 sponge (host side).

Algebraic sponge transcript with overwrite absorption and rescue-prime
padding (a trailing 1), and the query-index bit source that takes only the
low bits of each challenge, as era-boojum's transcript.rs and the JAX
package's transcript.py do. Everything it absorbs is read back from the
device once per round.

Two instances, as in the JAX package: `Poseidon2Transcript` over
Goldilocks (width 12, GF(p^2) challenges) and `Poseidon2BabyBearTranscript`
over BabyBear (width 16, GF(p^4) challenges); both rate 8.
"""

from .field.spec import BABYBEAR, GOLDILOCKS
from .hashes.poseidon2 import poseidon2_permutation_host
from .hashes.poseidon2_bb import poseidon2_permutation_bb_host

RATE = 8
CHALLENGE_BITS = GOLDILOCKS.challenge_bits


class Poseidon2Transcript:
    _SPEC = GOLDILOCKS
    _PERMUTATION = staticmethod(poseidon2_permutation_host)

    def __init__(self):
        self.state = [0] * self._SPEC.sponge_width
        self.buffer = []
        self.available = []

    def witness_field_elements(self, els):
        p = self._SPEC.p
        self.buffer.extend(int(e) % p for e in els)

    def witness_merkle_tree_cap(self, cap):
        for digest in cap:
            self.witness_field_elements(digest)

    def get_challenge(self) -> int:
        if not self.buffer:
            if self.available:
                return self.available.pop(0)
            self.state = self._PERMUTATION(self.state)
            self.available = list(self.state[:RATE])
            return self.available.pop(0)
        # rescue-prime padding: trailing 1, then zeros to a multiple of rate
        to_absorb = self.buffer + [1]
        self.buffer = []
        while len(to_absorb) % RATE:
            to_absorb.append(0)
        for i in range(0, len(to_absorb), RATE):
            self.state[:RATE] = to_absorb[i : i + RATE]
            self.state = self._PERMUTATION(self.state)
        self.available = list(self.state[:RATE])
        return self.available.pop(0)

    def get_multiple_challenges(self, n: int):
        return [self.get_challenge() for _ in range(n)]

    def get_ext_challenge(self):
        """One challenge per extension coordinate: 2 over Goldilocks, 4
        over BabyBear."""
        return tuple(self.get_challenge() for _ in range(self._SPEC.ext_degree))


class Poseidon2BabyBearTranscript(Poseidon2Transcript):
    _SPEC = BABYBEAR
    _PERMUTATION = staticmethod(poseidon2_permutation_bb_host)


TRANSCRIPTS = {
    "poseidon2": Poseidon2Transcript,
    "poseidon2_babybear": Poseidon2BabyBearTranscript,
}


def make_transcript(kind: str = "poseidon2"):
    if kind not in TRANSCRIPTS:
        raise ValueError(f"transcript {kind!r} is not ported (have {sorted(TRANSCRIPTS)})")
    return TRANSCRIPTS[kind]()


class BitSource:
    """Uniform query-index bits from transcript challenges: only the low
    (challenge_bits - max_needed_bits) bits of each challenge are used;
    challenge_bits is 64 over Goldilocks, 31 over BabyBear."""

    def __init__(self, max_needed_bits: int, challenge_bits: int = CHALLENGE_BITS):
        if not 0 < max_needed_bits < challenge_bits:
            raise ValueError(f"max_needed_bits {max_needed_bits} out of range")
        self.bits = []
        self.max_needed = max_needed_bits
        self.challenge_bits = challenge_bits

    def get_bits(self, transcript, num_bits: int):
        while len(self.bits) < num_bits:
            c = transcript.get_challenge()
            usable = self.challenge_bits - self.max_needed
            self.bits.extend((c >> i) & 1 for i in range(usable))
        out, self.bits = self.bits[:num_bits], self.bits[num_bits:]
        return out

    def get_index(self, transcript, num_bits: int) -> int:
        idx = 0
        for i, b in enumerate(self.get_bits(transcript, num_bits)):
            idx |= b << i
        return idx
