"""Byte-level circuit ops of the hash gadgets, as in the JAX package's
gadgets/byte_ops.py (era-boojum blake2s/mixing_function.rs xor_many and the
byte splits, keccak256/round_function.rs rotate_word): a word is a
little-endian list of byte variables; xor and and are 8-bit table lookups;
a rotation splits each byte through a table of its split point and merges
neighbouring halves with one FMA an output byte."""

from __future__ import annotations

from ..cs.gates.simple import FmaGate
from ..cs.lookup_table import and8_table, xor8_table
from .tables import byte_split_table


def ensure_xor8(cs):
    return cs.ensure_table("xor8", xor8_table)


def ensure_and8(cs):
    return cs.ensure_table("and8", and8_table)


def ensure_byte_split(cs, split_at: int):
    return cs.ensure_table(f"byte_split_at{split_at}", lambda: byte_split_table(split_at))


def xor_many(cs, a_bytes, b_bytes):
    xor_id = cs.get_table_id("xor8")
    return [cs.perform_lookup(xor_id, [a, b])[0] for a, b in zip(a_bytes, b_bytes)]


def and_many(cs, a_bytes, b_bytes):
    and_id = cs.get_table_id("and8")
    return [cs.perform_lookup(and_id, [a, b])[0] for a, b in zip(a_bytes, b_bytes)]


def range_check_byte(cs, v):
    """Hold v in [0, 256) by a xor8 lookup of (v, 0)."""
    cs.perform_lookup(cs.get_table_id("xor8"), [v, cs.zero_var()])


def rotate_bytes_left(cs, word, r: int):
    """A little-endian byte word rotated left by r bits: whole bytes are a
    relabeling; the rest, rem bits, splits each byte at 8 - rem and merges
    out[j] = low[(j - k) % nb]·2^rem + high[(j - k - 1) % nb]."""
    nb = len(word)
    k, rem = divmod(r % (8 * nb), 8)
    if rem == 0:
        return [word[(j - k) % nb] for j in range(nb)]
    split_id = cs.get_table_id(f"byte_split_at{8 - rem}")
    lows, highs = [], []
    for b in word:
        lo, hi = cs.perform_lookup(split_id, [b])
        lows.append(lo)
        highs.append(hi)
    one = cs.one_var()
    return [FmaGate.fma(cs, one, lows[(j - k) % nb], highs[(j - k - 1) % nb], 1 << rem, 1)
            for j in range(nb)]


def rotate_bytes_right(cs, word, r: int):
    return rotate_bytes_left(cs, word, 8 * len(word) - (r % (8 * len(word))))
