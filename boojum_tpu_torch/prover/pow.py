"""Proof-of-work grinding over the Poseidon2 sponge (era-boojum PoWRunner).

seed = 4 transcript challenges; find a nonce such that hash(seed ‖ nonce)[0]
has `pow_bits` low zero bits; the nonce is absorbed before query sampling.
The BabyBear prover grinds blake2s instead, over the same seed of 4
challenges (the JAX package's prover/pow.py blake2s_pow_grind).
"""

import hashlib

from ..hashes.poseidon2 import Poseidon2SpongeHost


def pow_grind(transcript, pow_bits: int) -> int:
    if pow_bits == 0:
        return 0
    if pow_bits > 32:
        raise ValueError("unreasonable pow difficulty")
    seed = transcript.get_multiple_challenges(4)
    mask = (1 << pow_bits) - 1
    nonce = 0
    while Poseidon2SpongeHost.hash_leaf(seed + [nonce])[0] & mask:
        nonce += 1
    transcript.witness_field_elements([nonce])
    return nonce


def pow_verify(transcript, pow_bits: int, nonce: int) -> bool:
    if pow_bits == 0:
        return True
    seed = transcript.get_multiple_challenges(4)
    if Poseidon2SpongeHost.hash_leaf(seed + [int(nonce)])[0] & ((1 << pow_bits) - 1):
        return False
    transcript.witness_field_elements([nonce])
    return True


def _blake2s_seed(transcript) -> bytes:
    """4 challenges as 8-byte little-endian words."""
    return b"".join(c.to_bytes(8, "little") for c in transcript.get_multiple_challenges(4))


def _blake2s_low_word(data: bytes) -> int:
    return int.from_bytes(hashlib.blake2s(data).digest()[:8], "little")


def blake2s_pow_grind(transcript, pow_bits: int) -> int:
    """Blake2s nonce search (era-boojum pow.rs:51): the first LE u64 of
    blake2s(seed ‖ nonce_le8) must have `pow_bits` low zero bits."""
    if pow_bits == 0:
        return 0
    if pow_bits > 32:
        raise ValueError("unreasonable pow difficulty")
    seed = _blake2s_seed(transcript)
    mask = (1 << pow_bits) - 1
    nonce = 0
    while _blake2s_low_word(seed + nonce.to_bytes(8, "little")) & mask:
        nonce += 1
    transcript.witness_field_elements([nonce])
    return nonce


def blake2s_pow_verify(transcript, pow_bits: int, nonce: int) -> bool:
    if pow_bits == 0:
        return True
    seed = _blake2s_seed(transcript)
    if _blake2s_low_word(seed + int(nonce).to_bytes(8, "little")) & ((1 << pow_bits) - 1):
        return False
    transcript.witness_field_elements([nonce])
    return True
