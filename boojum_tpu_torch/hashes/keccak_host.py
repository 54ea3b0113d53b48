"""Keccak-f[1600] and Keccak-256 over python ints, with the original 0x01
padding (Ethereum's keccak256), a copy of the JAX package's
hashes/keccak_host.py: the reference the keccak256 circuit's digest is
checked against.
"""

from __future__ import annotations

_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_M = (1 << 64) - 1


def _rol(x, r):
    r %= 64
    return ((x << r) | (x >> (64 - r))) & _M


def keccak_f1600(a):
    """In-place-style permutation over a 5x5 list-of-lists of u64."""
    for rc in _RC:
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rol(a[x][y], _ROT[x][y])
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
        a[0][0] ^= rc
    return a


def keccak256(data: bytes) -> bytes:
    """Ethereum-style Keccak-256 (0x01 domain padding, rate 136)."""
    rate = 136
    padlen = rate - len(data) % rate
    if padlen == 1:
        data = data + b"\x81"
    else:
        data = data + b"\x01" + b"\x00" * (padlen - 2) + b"\x80"
    a = [[0] * 5 for _ in range(5)]
    for off in range(0, len(data), rate):
        block = data[off : off + rate]
        for w in range(rate // 8):
            x, y = w % 5, w // 5
            a[x][y] ^= int.from_bytes(block[w * 8 : (w + 1) * 8], "little")
        a = keccak_f1600(a)
    out = b""
    for w in range(4):
        x, y = w % 5, w // 5
        out += a[x][y].to_bytes(8, "little")
    return out
