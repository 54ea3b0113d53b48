"""Goldilocks field GF(p), p = 2^64 - 2^32 + 1, as elementwise torch ops.

An element is one 64-bit word held in a `torch.int64` tensor as its unsigned
bit pattern; every stored value is canonical (in [0, p)). torch has no
unsigned 64-bit arithmetic, so:
- unsigned compares flip the sign bit first (x ^ 2^63) and compare signed;
- a right shift is arithmetic, so it is followed by a mask;
- adds and multiplies wrap modulo 2^64, which is what the carries expect.

These are the plain versions of the field: they run on any device and are
what the port's non-kernel work (batch inversion, prefix products, DEEP,
evaluations at z) uses. The CUDA kernels carry the same functions in
`csrc/goldilocks.cuh`. The 128-bit product reduction is the standard
identity 2^64 = 2^32 - 1, 2^96 = -1 (mod p): with x = hi·2^64 + lo and
hi = hh·2^32 + hl, x = lo - hh + hl·(2^32 - 1).

Operands may be tensors or python ints (canonical field values); at least
one operand of every op must be a tensor.
"""

import numpy as np
import torch

from . import gl

P = gl.P
EPSILON = gl.EPSILON
M32 = 0xFFFFFFFF
_MIN = -(1 << 63)  # sign bit as an int64 literal


def as_i64(v: int) -> int:
    """A canonical field value as the int64 literal with the same bits."""
    v = int(v)
    return v - (1 << 64) if v >= (1 << 63) else v


def as_u64(v: int) -> int:
    """The unsigned value of an int64 bit pattern."""
    v = int(v)
    return v + (1 << 64) if v < 0 else v


P_I64 = as_i64(P)
_P_FLIP = P ^ (1 << 63)  # p with its sign bit flipped, a positive int64


def from_numpy(arr, device="cpu") -> torch.Tensor:
    """uint64 numpy array -> int64 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint64))
    return torch.from_numpy(a.view(np.int64).copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> uint64 numpy array with the same bits."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint64)


def ult(a, b):
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ _MIN) < (b ^ _MIN)


def _ge_p(x):
    return (x ^ _MIN) >= _P_FLIP


def _lsr32(x):
    return (x >> 32) & M32


def _const(v):
    return as_i64(v) if isinstance(v, int) else v


def add(a, b):
    a, b = _const(a), _const(b)
    s = a + b
    # on a carry out of 64 bits the true value is s + 2^64 = s + eps (mod p)
    s = torch.where(ult(s, a), s + EPSILON, s)
    return torch.where(_ge_p(s), s - P_I64, s)


def sub(a, b):
    a, b = _const(a), _const(b)
    d = a - b
    # on a borrow the true value is d - 2^64 = d - eps (mod p)
    return torch.where(ult(a, b), d - EPSILON, d)


def neg(a):
    return torch.where(a == 0, a, P_I64 - a)


def double(a):
    return add(a, a)


def _halves(x):
    if isinstance(x, int):
        return x & M32, x >> 32
    return x & M32, _lsr32(x)


def mul_wide(a, b):
    """Full 64x64 -> 128-bit product as a (hi, lo) pair of int64 words."""
    a_lo, a_hi = _halves(a)
    b_lo, b_hi = _halves(b)
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = lh + hl
    mid_carry = ult(mid, lh).to(torch.int64)
    lo = ll + (mid << 32)
    lo_carry = ult(lo, ll).to(torch.int64)
    hi = hh + _lsr32(mid) + (mid_carry << 32) + lo_carry
    return hi, lo


def reduce128(hi, lo):
    """Reduce the 128-bit value hi·2^64 + lo to a canonical element."""
    hi_hi = _lsr32(hi)
    hi_lo = hi & M32
    t0 = lo - hi_hi
    t0 = torch.where(ult(lo, hi_hi), t0 - EPSILON, t0)
    t1 = hi_lo * EPSILON  # < 2^64
    t2 = t0 + t1
    res = torch.where(ult(t2, t0), t2 + EPSILON, t2)
    return torch.where(_ge_p(res), res - P_I64, res)


def mul(a, b):
    if isinstance(a, int) and isinstance(b, int):
        raise TypeError("mul needs at least one tensor operand")
    return reduce128(*mul_wide(a, b))


def sqr(a):
    return mul(a, a)


def mul_small(a, k: int):
    return mul(a, int(k) % P)


def pow_const(a, e: int):
    """a ** e for a python-int exponent (square and multiply)."""
    e = int(e)
    if e < 0:
        raise ValueError("negative exponent")
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = sqr(base)
    return torch.ones_like(a) if result is None else result


def inv(a):
    """Fermat inverse a^(p-2); the inverse of 0 comes out as 0."""
    return pow_const(a, P - 2)


def prefix_product(a):
    """Inclusive prefix product along the last axis by log-doubling."""
    n = a.shape[-1]
    shift = 1
    while shift < n:
        shifted = torch.ones_like(a)
        shifted[..., shift:] = a[..., :-shift]
        a = mul(a, shifted)
        shift *= 2
    return a


def batch_inverse(a):
    """Montgomery batch inversion along the last axis: two prefix-product
    passes and one Fermat inversion."""
    prefix = prefix_product(a)
    total_inv = inv(prefix[..., -1:])
    rev_prefix = prefix_product(torch.flip(a, dims=(-1,)))
    # prod(a[i+1:]) = rev_prefix[n-2-i] for i < n-1, 1 for i = n-1
    suffix = torch.ones_like(a)
    suffix[..., :-1] = torch.flip(rev_prefix[..., :-1], dims=(-1,))
    shifted_prefix = torch.ones_like(a)
    shifted_prefix[..., 1:] = prefix[..., :-1]
    return mul(mul(suffix, total_inv), shifted_prefix)


def modsum(a, dim: int = -1):
    """Modular sum along one axis by pairwise folding."""
    a = a.movedim(dim, -1)
    n = a.shape[-1]
    if n == 0:
        return torch.zeros(a.shape[:-1], dtype=torch.int64, device=a.device)
    while n > 1:
        if n % 2:
            a = torch.cat([a, torch.zeros_like(a[..., :1])], dim=-1)
            n += 1
        a = add(a[..., : n // 2], a[..., n // 2 :])
        n //= 2
    return a[..., 0]


def powers(base: int, count: int, device) -> torch.Tensor:
    """[1, b, ..., b^(count-1)] by log-doubling on the device: each step
    multiplies the powers so far by b^cur."""
    base = int(base) % P
    out = torch.ones(count, dtype=torch.int64, device=device)
    cur = 1
    while cur < count:
        nxt = min(cur, count - cur)
        out[cur : cur + nxt] = mul(out[:nxt], gl.pow_(base, cur))
        cur += nxt
    return out
