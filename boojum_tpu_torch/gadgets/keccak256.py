"""Keccak-256 gadget, as in the JAX package's gadgets/keccak256.py
(era-boojum gadgets/keccak256: mod.rs `keccak256`, round_function.rs
`keccak_256_round_function`): the 1600-bit state is a
5x5 matrix of 64-bit lanes, each lane carried as 8 little-endian byte
variables; xor/and are 8-bit-table lookups (the field is ~64 bits so a sparse
base buys nothing, as in era-boojum),
bit rotations split bytes via per-split lookup tables and remerge with FMA
gates, and NOT(a) is `255 - a` on an arithmetic gate.

Keccak padding is the original 0x01 domain (Ethereum-style), NOT NIST SHA-3's
0x06.
"""

from __future__ import annotations

from ..cs.gates.simple import FmaGate
from .byte_ops import (
    and_many,
    ensure_and8,
    ensure_byte_split,
    ensure_xor8,
    rotate_bytes_left,
    xor_many,
)

LANE_WIDTH = 5
BYTES_PER_WORD = 8
NUM_ROUNDS = 24
RATE_BYTES = 136
DIGEST_SIZE = 32

ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]


def register_keccak_tables(cs):
    """Register xor8/and8 and every byte-split table the rotations need."""
    ensure_xor8(cs)
    ensure_and8(cs)
    for split_at in range(1, 8):
        ensure_byte_split(cs, split_at)


def rotate_word(cs, word, r: int):
    """A 64-bit lane (8 little-endian byte variables) rotated left by r
    bits."""
    return rotate_bytes_left(cs, word, r)


def _not_byte(cs, v, neg_const):
    """255 - v."""
    return FmaGate.fma(cs, cs.one_var(), v, neg_const, cs.p - 1, 1)


def keccak_1600_round(cs, state, round_constant: int):
    """One Keccak-f[1600] round over the 5x5x8 byte-variable state."""
    # theta
    c = []
    for i in range(LANE_WIDTH):
        tmp = xor_many(cs, state[i][0], state[i][1])
        tmp = xor_many(cs, tmp, state[i][2])
        tmp = xor_many(cs, tmp, state[i][3])
        tmp = xor_many(cs, tmp, state[i][4])
        c.append(tmp)
    c_rot = [rotate_word(cs, c[i], 1) for i in range(LANE_WIDTH)]
    d = [
        xor_many(cs, c[(i - 1) % LANE_WIDTH], c_rot[(i + 1) % LANE_WIDTH])
        for i in range(LANE_WIDTH)
    ]
    for i in range(LANE_WIDTH):
        for j in range(LANE_WIDTH):
            state[i][j] = xor_many(cs, state[i][j], d[i])

    # rho and pi
    i, j = 1, 0
    current = state[i][j]
    for idx in range(24):
        i, j = j, (2 * i + 3 * j) % LANE_WIDTH
        existing = state[i][j]
        rotation = (((idx + 1) * (idx + 2)) >> 1) % 64
        state[i][j] = rotate_word(cs, current, rotation)
        current = existing

    # chi
    neg_const = cs.allocate_constant((1 << 8) - 1)
    for j in range(LANE_WIDTH):
        t = [state[i][j] for i in range(LANE_WIDTH)]
        for i in range(LANE_WIDTH):
            nt = [_not_byte(cs, b, neg_const) for b in t[(i + 1) % LANE_WIDTH]]
            tmp = and_many(cs, nt, t[(i + 2) % LANE_WIDTH])
            state[i][j] = xor_many(cs, tmp, t[i])

    # iota
    rc = [
        cs.allocate_constant((round_constant >> (8 * b)) & 0xFF)
        for b in range(8)
    ]
    state[0][0] = xor_many(cs, state[0][0], rc)


def keccak_256_round_function(cs, state):
    for rc in ROUND_CONSTANTS:
        keccak_1600_round(cs, state, rc)


def keccak256(cs, input_bytes) -> list:
    """Keccak-256 over a list of byte variables; returns the 32 digest byte
    variables."""
    register_keccak_tables(cs)
    zero = cs.zero_var()
    state = [
        [[zero] * BYTES_PER_WORD for _ in range(LANE_WIDTH)]
        for _ in range(LANE_WIDTH)
    ]

    padded = list(input_bytes)
    padlen = RATE_BYTES - len(padded) % RATE_BYTES
    if padlen == 1:
        padded.append(cs.allocate_constant(0x81))
    else:
        padded.append(cs.allocate_constant(0x01))
        padded.extend([zero] * (padlen - 2))
        padded.append(cs.allocate_constant(0x80))

    for off in range(0, len(padded), RATE_BYTES):
        block = padded[off : off + RATE_BYTES]
        for j in range(LANE_WIDTH):
            for i in range(LANE_WIDTH):
                w = i + LANE_WIDTH * j
                if w < RATE_BYTES // BYTES_PER_WORD:
                    lane = block[w * BYTES_PER_WORD : (w + 1) * BYTES_PER_WORD]
                    state[i][j] = xor_many(cs, state[i][j], lane)
        keccak_256_round_function(cs, state)

    out = []
    for i in range(DIGEST_SIZE // BYTES_PER_WORD):
        out.extend(state[i][0])
    return out


def keccak256_digest_bytes(cs, digest) -> bytes:
    """The digest's bytes from the witness."""
    return bytes(int(cs.get_value(v)) for v in digest)
