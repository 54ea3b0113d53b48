"""Circuit gadgets: the sha256 circuit and its 4-bit-chunk tables, the
Boolean, Num and UInt gadgets, the byte ops over the 8-bit tables, the
keccak256 and blake2s circuits, the wide integers (UInt160/256/512), the
non-native fields and the short-Weierstrass curves over them, derived
composite gadgets and the field-like ops over circuit variables; in their
modules, the Poseidon2 and legacy Poseidon sponges over circuit variables
(poseidon2_rf, poseidon_rf), the committed queues and their sponge
optimizer (queue, queue_optimizer) and the recursive verifier
(recursion/)."""

from .blake2s import blake2s, blake2s_digest_bytes
from .boolean import Boolean
from .curves import SWProjectivePoint, ZeroableAffinePoint
from .derive import derive_gadget, encode_variables
from .field_like_circuit import CircuitExtOps, CircuitOps
from .keccak256 import keccak256, keccak256_digest_bytes
from .non_native_field import (
    BN254_BASE, SECP256K1_BASE, SECP256K1_SCALAR, NNFParams, NonNativeField,
)
from .num import Num
from .sha256 import allocate_u8_input, sha256, sha256_digest_bytes
from .uint import UInt8, UInt16, UInt32
from .wide_int import UInt160, UInt256, UInt512

__all__ = ["BN254_BASE", "Boolean", "CircuitExtOps", "CircuitOps", "NNFParams",
           "NonNativeField", "Num", "SECP256K1_BASE", "SECP256K1_SCALAR",
           "SWProjectivePoint", "UInt8", "UInt16", "UInt32", "UInt160", "UInt256", "UInt512",
           "ZeroableAffinePoint", "allocate_u8_input", "blake2s", "blake2s_digest_bytes",
           "derive_gadget", "encode_variables", "keccak256", "keccak256_digest_bytes", "sha256",
           "sha256_digest_bytes"]
