"""Circuit gadgets: the sha256 circuit and its 4-bit-chunk tables, the
Boolean, Num and UInt gadgets, the byte ops over the 8-bit tables, and the
keccak256 and blake2s circuits."""

from .blake2s import blake2s, blake2s_digest_bytes
from .boolean import Boolean
from .keccak256 import keccak256, keccak256_digest_bytes
from .num import Num
from .sha256 import allocate_u8_input, sha256, sha256_digest_bytes
from .uint import UInt8, UInt16, UInt32

__all__ = ["Boolean", "Num", "UInt8", "UInt16", "UInt32", "allocate_u8_input", "blake2s",
           "blake2s_digest_bytes", "keccak256", "keccak256_digest_bytes", "sha256",
           "sha256_digest_bytes"]
