"""Host-side scalar Goldilocks arithmetic over python ints, p = 2^64 - 2^32 + 1.

Used where the work is sequential and tiny (transcript, verifier, witness
values, twiddle and domain tables). Tensor arithmetic lives in
`goldilocks.py`; the numpy forms here build host tables in bulk.
"""

import numpy as np

P = 0xFFFFFFFF00000001
EPSILON = 0xFFFFFFFF  # 2^64 mod p
MULTIPLICATIVE_GENERATOR = 7
RADIX_2_SUBGROUP_GENERATOR = 0x185629DCDA58878C  # order 2^32
TWO_ADICITY = 32
HALF = (P + 1) // 2  # 1/2 mod p


def add(a: int, b: int) -> int:
    s = a + b
    return s - P if s >= P else s


def sub(a: int, b: int) -> int:
    d = a - b
    return d + P if d < 0 else d


def neg(a: int) -> int:
    return 0 if a == 0 else P - a


def mul(a: int, b: int) -> int:
    return (a * b) % P


def sqr(a: int) -> int:
    return (a * a) % P


def pow_(a: int, e: int) -> int:
    return pow(a, e, P)


def inv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("inverse of zero in GF(p)")
    return pow(a, P - 2, P)


def omega(log_n: int) -> int:
    """Primitive 2^log_n-th root of unity (two-adic tower)."""
    if not 0 <= log_n <= TWO_ADICITY:
        raise ValueError(f"no 2^{log_n}-th root of unity in GF(p)")
    w = RADIX_2_SUBGROUP_GENERATOR
    for _ in range(TWO_ADICITY - log_n):
        w = (w * w) % P
    return w


def mul_np(a, b) -> np.ndarray:
    """Canonical Goldilocks multiply on uint64 numpy arrays: 32-bit
    schoolbook to the 128-bit product, then 2^64 = eps, 2^96 = -1."""
    u64 = np.uint64
    m32 = u64(0xFFFFFFFF)
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    with np.errstate(over="ignore"):
        a_lo, a_hi = a & m32, a >> u64(32)
        b_lo, b_hi = b & m32, b >> u64(32)
        ll, lh, hl, hh = a_lo * b_lo, a_lo * b_hi, a_hi * b_lo, a_hi * b_hi
        mid = lh + hl
        mid_carry = (mid < lh).astype(np.uint64)
        lo = ll + (mid << u64(32))
        lo_carry = (lo < ll).astype(np.uint64)
        hi = hh + (mid >> u64(32)) + (mid_carry << u64(32)) + lo_carry
        hi_lo, hi_hi = hi & m32, hi >> u64(32)
        t0 = lo - hi_hi
        t0 = np.where(lo < hi_hi, t0 - m32, t0)
        t1 = hi_lo * m32
        res = t0 + t1
        res = np.where(res < t1, res + m32, res)
        return np.where(res >= u64(P), res - u64(P), res)


def powers_np(base: int, count: int) -> np.ndarray:
    """[1, b, ..., b^(count-1)] as a uint64 numpy array (log-doubling)."""
    out = np.ones(count, dtype=np.uint64)
    cur = 1
    while cur < count:
        step = np.uint64(pow_(base, cur))
        nxt = min(cur, count - cur)
        out[cur : cur + nxt] = mul_np(out[:nxt], step)
        cur += nxt
    return out
