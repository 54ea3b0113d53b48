"""Proof-of-work grinding over the Poseidon2 sponge (era-boojum PoWRunner).

seed = 4 transcript challenges; find a nonce such that hash(seed ‖ nonce)[0]
has `pow_bits` low zero bits; the nonce is absorbed before query sampling.
"""

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
