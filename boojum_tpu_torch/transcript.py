"""Fiat-Shamir transcript over the Poseidon2 sponge (host side).

Algebraic sponge transcript with overwrite absorption and rescue-prime
padding (a trailing 1), and the query-index bit source that takes only the
low bits of each challenge, as era-boojum's transcript.rs and the JAX
package's transcript.py do. Everything it absorbs is read back from the
device once per round.

The six kinds of the JAX package, named as its `TRANSCRIPTS` names them:
- `poseidon2`: the sponge over Goldilocks (width 12, GF(p^2) challenges);
- `poseidon`: the same sponge over the legacy Poseidon permutation;
- `blake2s`, `keccak256`: byte transcripts (era-boojum Blake2sTranscript
  and Keccak256Transcript): field elements absorb as little-endian words,
  and each challenge request folds the pending bytes into a running 32-byte
  seed, then squeezes hash(seed ‖ counter_le4) blocks, each word reduced
  mod p;
- `poseidon2_babybear`, `blake2s_babybear`: the sponge and the blake2s
  transcript at BabyBear's record (width 16, 4-byte words, GF(p^4)
  challenges).
The transcript picks no tree hasher: Merkle trees hash with Poseidon2.
"""

import hashlib

from .field.spec import BABYBEAR, GOLDILOCKS
from .hashes.keccak_host import keccak256
from .hashes.poseidon import poseidon_permutation_host
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


class PoseidonTranscript(Poseidon2Transcript):
    """The sponge transcript over the legacy Poseidon permutation."""

    _PERMUTATION = staticmethod(poseidon_permutation_host)


class _ByteTranscript:
    """A byte transcript; a subclass gives the hash (`_hash`) and may give a
    field record (`_SPEC`: the word width, the modulus, the extension
    degree)."""

    _SPEC = GOLDILOCKS

    def __init__(self):
        self.seed = b"\x00" * 32
        self.buffer = bytearray()
        self.counter = 0
        self.available = []

    @staticmethod
    def _hash(data: bytes) -> bytes:
        raise NotImplementedError

    def witness_field_elements(self, els):
        p, width = self._SPEC.p, self._SPEC.elem_bytes
        for e in els:
            self.buffer += (int(e) % p).to_bytes(width, "little")

    def witness_merkle_tree_cap(self, cap):
        for digest in cap:
            self.witness_field_elements(digest)

    def get_challenge(self) -> int:
        p, width = self._SPEC.p, self._SPEC.elem_bytes
        if self.buffer:
            self.seed = self._hash(self.seed + bytes(self.buffer))
            self.buffer = bytearray()
            self.counter = 0
            self.available = []
        if not self.available:
            block = self._hash(self.seed + self.counter.to_bytes(4, "little"))
            self.counter += 1
            self.available = [int.from_bytes(block[i:i + width], "little") % p
                              for i in range(0, 32, width)]
        return self.available.pop(0)

    def get_multiple_challenges(self, n: int):
        return [self.get_challenge() for _ in range(n)]

    def get_ext_challenge(self):
        return tuple(self.get_challenge() for _ in range(self._SPEC.ext_degree))


def blake2s_digest(data: bytes) -> bytes:
    return hashlib.blake2s(data).digest()


class Blake2sTranscript(_ByteTranscript):
    _hash = staticmethod(blake2s_digest)


class Keccak256Transcript(_ByteTranscript):
    _hash = staticmethod(keccak256)


class Blake2sBabyBearTranscript(Blake2sTranscript):
    """4-byte words, 8 challenge words a squeezed block."""

    _SPEC = BABYBEAR


TRANSCRIPTS = {
    "poseidon2": Poseidon2Transcript,
    "poseidon": PoseidonTranscript,
    "blake2s": Blake2sTranscript,
    "keccak256": Keccak256Transcript,
    "poseidon2_babybear": Poseidon2BabyBearTranscript,
    "blake2s_babybear": Blake2sBabyBearTranscript,
}


def checked_transcript(kind: str) -> str:
    """`kind` if it names a transcript, else ValueError."""
    if kind not in TRANSCRIPTS:
        raise ValueError(f"unknown transcript kind {kind!r} (have {sorted(TRANSCRIPTS)})")
    return kind


def make_transcript(kind: str = "poseidon2"):
    return TRANSCRIPTS[checked_transcript(kind)]()


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
