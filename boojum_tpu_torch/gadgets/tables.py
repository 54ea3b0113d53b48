"""The gadgets' lookup tables, as in the JAX package's gadgets/tables.py
(era-boojum gadgets/tables: trixor4.rs, ch4.rs, maj4.rs, chunk4bits.rs,
byte_split.rs; the 8-bit binary tables are in cs/lookup_table.py). Every
table is at most 4 wide, to fit width-4 sub-arguments.
"""

from __future__ import annotations

import numpy as np

from ..cs.lookup_table import LookupTable


def _tri_table(name: str, fn) -> LookupTable:
    """Every (a, b, c) in [0, 16)^3 -> fn(a, b, c) & 0xF; 4096 rows."""
    a = np.arange(16, dtype=np.uint64).repeat(256)
    b = np.tile(np.arange(16, dtype=np.uint64).repeat(16), 16)
    c = np.tile(np.arange(16, dtype=np.uint64), 256)
    v = fn(a, b, c) & np.uint64(0xF)
    return LookupTable(name, 3, 1, np.stack([a, b, c, v], axis=1))


def trixor4_table() -> LookupTable:
    """a ^ b ^ c on 4-bit chunks; membership also range-checks a chunk."""
    return _tri_table("trixor4", lambda a, b, c: a ^ b ^ c)


def ch4_table() -> LookupTable:
    """sha256 choice (a & b) ^ (~a & c) on 4-bit chunks."""
    return _tri_table("ch4", lambda a, b, c: (a & b) ^ (~a & c))


def maj4_table() -> LookupTable:
    """sha256 majority (a & b) ^ (a & c) ^ (b & c) on 4-bit chunks."""
    return _tri_table("maj4", lambda a, b, c: (a & b) ^ (a & c) ^ (b & c))


def byte_split_table(split_at: int) -> LookupTable:
    """x in [0, 256) -> (x mod 2^split_at, x >> split_at): the byte
    rotations of keccak256 and blake2s, one table a split point."""
    if not 0 < split_at < 8:
        raise ValueError("split_at must lie in 1..7")
    x = np.arange(256, dtype=np.uint64)
    low = x & np.uint64((1 << split_at) - 1)
    high = x >> np.uint64(split_at)
    return LookupTable(f"byte_split_at{split_at}", 1, 2, np.stack([x, low, high], axis=1))


def split4bit_table(split_at: int) -> LookupTable:
    """x in [0, 16) -> (x & mask, x >> split_at, the two parts swapped)."""
    if split_at not in (1, 2):
        raise ValueError("split_at must be 1 or 2")
    x = np.arange(16, dtype=np.uint64)
    low = x & np.uint64((1 << split_at) - 1)
    high = x >> np.uint64(split_at)
    rev = (low << np.uint64(4 - split_at)) | high
    return LookupTable(f"split4bit_at{split_at}", 1, 3,
                       np.stack([x, low, high, rev], axis=1))
