"""Circuit gadgets of the sha256 slice: its 4-bit-chunk tables, chunk range
checks and recomposition, and the sha256 compression circuit."""

from .sha256 import allocate_u8_input, sha256, sha256_digest_bytes

__all__ = ["allocate_u8_input", "sha256", "sha256_digest_bytes"]
