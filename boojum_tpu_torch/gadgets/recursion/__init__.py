"""The recursive verification layer of the JAX package's
gadgets/recursion/ (era-boojum gadgets/recursion/): a Boojum verifier as a
circuit, so that one proof attests to another."""

from .allocated_proof import AllocatedProof, AllocatedVerificationKey
from .transcript import CircuitBitSource, CircuitTranscript, decompose_challenge_canonical
from .verifier import recursive_verify

__all__ = ["AllocatedProof", "AllocatedVerificationKey", "CircuitBitSource",
           "CircuitTranscript", "decompose_challenge_canonical", "recursive_verify"]
