"""Blake2s gadget, as in the JAX package's gadgets/blake2s.py (era-boojum
gadgets/blake2s: mod.rs `blake2s`, round_function.rs, mixing_function.rs
`mixing_function_g`): state words are
little-endian 4-byte-variable words; additions are one chunked tri-add gate
per `+` (carry range-checked by lookup), xors are 8-bit-table lookups, and the
four G rotations are byte relabelings (16, 8) or split/remerge lookups
(12, 7), as in era-boojum.

Fixed-length, keyless hashing (digest 32): h0 is IV0 twisted by the param
block `0x01010020` (era-boojum mod.rs `IV_0_TWIST`).
"""

from __future__ import annotations

from ..cs.gates.u32 import ByteTriAddGate
from .byte_ops import (
    ensure_byte_split,
    ensure_xor8,
    range_check_byte,
    rotate_bytes_right,
    xor_many,
)

BLAKE2S_ROUNDS = 10
BLOCK_SIZE = 64
DIGEST_SIZE = 32

IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]

IV_0_TWIST = IV[0] ^ 0x01010000 ^ 32

SIGMAS = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]


def register_blake2s_tables(cs):
    ensure_xor8(cs)
    ensure_byte_split(cs, 4)  # rotr 12 -> rotl 20, rem 4
    ensure_byte_split(cs, 7)  # rotr 7 -> rotl 25, rem 1 -> split at 7


def _const_word(cs, value: int):
    return [cs.allocate_constant((value >> (8 * i)) & 0xFF) for i in range(4)]


def _tri_add(cs, a, b, x):
    """(a + b + x) mod 2^32 on byte words, the carry range-checked
    (era-boojum mixing_function.rs `tri_add_as_byte_chunks`)."""
    out, carry = ByteTriAddGate.add(cs, a, b, x)
    range_check_byte(cs, carry)
    return out


def _g(cs, v, idxes, x, y, zero_word):
    """The G mixing function. Every tri-add output byte is then a key of a
    xor lookup, which range-checks it."""
    ia, ib, ic, id_ = idxes
    a, b, c, d = v[ia], v[ib], v[ic], v[id_]

    a = _tri_add(cs, a, b, x)
    d = rotate_bytes_right(cs, xor_many(cs, d, a), 16)
    c = _tri_add(cs, c, d, zero_word)
    b = rotate_bytes_right(cs, xor_many(cs, b, c), 12)
    a = _tri_add(cs, a, b, y)
    d = rotate_bytes_right(cs, xor_many(cs, d, a), 8)
    c = _tri_add(cs, c, d, zero_word)
    b = rotate_bytes_right(cs, xor_many(cs, b, c), 7)

    v[ia], v[ib], v[ic], v[id_] = a, b, c, d


def _compression(cs, h, block_words, offset: int, is_last: bool, zero_word):
    """One Blake2s compression (era-boojum round_function.rs, fixed
    length: the t and f words are constants)."""
    v = list(h)
    v += [_const_word(cs, IV[i]) for i in range(4)]
    v.append(_const_word(cs, IV[4] ^ (offset & 0xFFFFFFFF)))
    v.append(_const_word(cs, IV[5] ^ (offset >> 32)))
    v.append(_const_word(cs, IV[6] ^ (0xFFFFFFFF if is_last else 0)))
    v.append(_const_word(cs, IV[7]))

    for rnd in range(BLAKE2S_ROUNDS):
        s = SIGMAS[rnd]
        _g(cs, v, (0, 4, 8, 12), block_words[s[0]], block_words[s[1]], zero_word)
        _g(cs, v, (1, 5, 9, 13), block_words[s[2]], block_words[s[3]], zero_word)
        _g(cs, v, (2, 6, 10, 14), block_words[s[4]], block_words[s[5]], zero_word)
        _g(cs, v, (3, 7, 11, 15), block_words[s[6]], block_words[s[7]], zero_word)
        _g(cs, v, (0, 5, 10, 15), block_words[s[8]], block_words[s[9]], zero_word)
        _g(cs, v, (1, 6, 11, 12), block_words[s[10]], block_words[s[11]], zero_word)
        _g(cs, v, (2, 7, 8, 13), block_words[s[12]], block_words[s[13]], zero_word)
        _g(cs, v, (3, 4, 9, 14), block_words[s[14]], block_words[s[15]], zero_word)

    return [
        xor_many(cs, xor_many(cs, h[i], v[i]), v[i + 8]) for i in range(8)
    ]


def blake2s(cs, input_bytes) -> list:
    """Blake2s-256 over a list of byte variables; returns the 32 digest
    byte variables."""
    register_blake2s_tables(cs)
    zero = cs.zero_var()
    zero_word = [zero] * 4

    h = [
        _const_word(cs, IV_0_TWIST if i == 0 else IV[i]) for i in range(8)
    ]

    data = list(input_bytes)
    num_blocks = max(1, (len(data) + BLOCK_SIZE - 1) // BLOCK_SIZE)
    for blk in range(num_blocks):
        chunk = data[blk * BLOCK_SIZE : (blk + 1) * BLOCK_SIZE]
        is_last = blk == num_blocks - 1
        if is_last:
            offset = len(data)
            chunk = chunk + [zero] * (BLOCK_SIZE - len(chunk))
        else:
            offset = (blk + 1) * BLOCK_SIZE
        words = [chunk[4 * i : 4 * i + 4] for i in range(16)]
        h = _compression(cs, h, words, offset, is_last, zero_word)

    out = []
    for w in h:
        out.extend(w)
    return out


def blake2s_digest_bytes(cs, digest) -> bytes:
    return bytes(int(cs.get_value(v)) for v in digest)
