"""Proof-of-work grinding (era-boojum PoWRunner), as in the JAX package's
prover/pow.py.

The Poseidon2 runner: seed = 4 transcript challenges; find a nonce such
that hash(seed ‖ nonce)[0] has `pow_bits` low zero bits; the nonce is
absorbed before query sampling. The Goldilocks prover grinds it whatever
its transcript kind, as the JAX prover does.

The byte runners (era-boojum pow.rs:51 blake2s, :140 keccak256): seed = 4
challenges as 8-byte little-endian words; the first little-endian u64 of
hash(seed ‖ nonce_le8) must have `pow_bits` low zero bits. The BabyBear
provers grind blake2s.
"""

from ..hashes.keccak_host import keccak256
from ..hashes.poseidon2 import Poseidon2SpongeHost
from ..transcript import blake2s_digest


def _check_bits(pow_bits: int) -> None:
    if pow_bits > 32:
        raise ValueError("unreasonable pow difficulty")


def pow_grind(transcript, pow_bits: int) -> int:
    if pow_bits == 0:
        return 0
    _check_bits(pow_bits)
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


def _byte_seed(transcript) -> bytes:
    """4 challenges as 8-byte little-endian words."""
    return b"".join(c.to_bytes(8, "little") for c in transcript.get_multiple_challenges(4))


def _byte_pow_grind(transcript, pow_bits: int, hasher) -> int:
    if pow_bits == 0:
        return 0
    _check_bits(pow_bits)
    seed = _byte_seed(transcript)
    mask = (1 << pow_bits) - 1
    nonce = 0
    while int.from_bytes(hasher(seed + nonce.to_bytes(8, "little"))[:8], "little") & mask:
        nonce += 1
    transcript.witness_field_elements([nonce])
    return nonce


def _byte_pow_verify(transcript, pow_bits: int, nonce: int, hasher) -> bool:
    if pow_bits == 0:
        return True
    seed = _byte_seed(transcript)
    low = int.from_bytes(hasher(seed + int(nonce).to_bytes(8, "little"))[:8], "little")
    if low & ((1 << pow_bits) - 1):
        return False
    transcript.witness_field_elements([nonce])
    return True


def blake2s_pow_grind(transcript, pow_bits: int) -> int:
    return _byte_pow_grind(transcript, pow_bits, blake2s_digest)


def blake2s_pow_verify(transcript, pow_bits: int, nonce: int) -> bool:
    return _byte_pow_verify(transcript, pow_bits, nonce, blake2s_digest)


def keccak256_pow_grind(transcript, pow_bits: int) -> int:
    return _byte_pow_grind(transcript, pow_bits, keccak256)


def keccak256_pow_verify(transcript, pow_bits: int, nonce: int) -> bool:
    return _byte_pow_verify(transcript, pow_bits, nonce, keccak256)
