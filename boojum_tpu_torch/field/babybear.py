"""BabyBear field GF(p), p = 2^31 - 2^27 + 1, and GF(p^4) = GF(p)[w]/(w^4 - 11).

An element is stored as one `torch.int32` word: every canonical element is
below 2^31. The ops below widen to int64 for the arithmetic (a sum of two
canonical words reaches 2^32 - 2^28, past int32; a product reaches 2^62)
and narrow the canonical result back to the operands' word type: int32,
or int64 where an operand is an int64 tensor, which lets a long chain of
ops skip the conversions. Operands may be tensors or python ints; at
least one operand of every op is a tensor.

Extension elements are (4, ...) tensors, coordinate k being the
coefficient of w^k, as the JAX package stacks them at its public
functions; an ext operand may also be a host 4-tuple of ints.

Three layers, as in the JAX package's field/babybear.py: host scalars over
python ints (`*_s`, the transcript and the verifier), numpy host tables
(`mul_np`, `powers_np`: the setup's sigma columns), and the tensor ops.
"""

from __future__ import annotations

import numpy as np
import torch

from .spec import BABYBEAR as SPEC

P = SPEC.p
MULTIPLICATIVE_GENERATOR = SPEC.multiplicative_generator
EXT_NONRESIDUE = SPEC.ext_nonresidue  # w^4 = 11
INV2 = SPEC.half
DTYPE = torch.int32


# ---------------------------------------------------------------------------
# Host scalars (python ints)
# ---------------------------------------------------------------------------


def add_s(a: int, b: int) -> int:
    s = a + b
    return s - P if s >= P else s


def sub_s(a: int, b: int) -> int:
    d = a - b
    return d + P if d < 0 else d


def neg_s(a: int) -> int:
    return 0 if a == 0 else P - a


def mul_s(a: int, b: int) -> int:
    return (a * b) % P


def pow_s(a: int, e: int) -> int:
    return pow(a, e, P)


def inv_s(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("inverse of zero in BabyBear")
    return pow(a, P - 2, P)


def omega(log_n: int) -> int:
    return SPEC.omega(log_n)


ZERO_S = (0, 0, 0, 0)
ONE_S = (1, 0, 0, 0)


def ext_from_base_s(a: int):
    return (int(a) % P, 0, 0, 0)


def ext_add_s(a, b):
    return tuple(add_s(x, y) for x, y in zip(a, b))


def ext_sub_s(a, b):
    return tuple(sub_s(x, y) for x, y in zip(a, b))


def ext_neg_s(a):
    return tuple(neg_s(x) for x in a)


def ext_mul_s(a, b):
    """Schoolbook with w^4 = 11."""
    a0, a1, a2, a3 = a
    b0, b1, b2, b3 = b
    nr = EXT_NONRESIDUE
    return (
        (a0 * b0 + nr * (a1 * b3 + a2 * b2 + a3 * b1)) % P,
        (a0 * b1 + a1 * b0 + nr * (a2 * b3 + a3 * b2)) % P,
        (a0 * b2 + a1 * b1 + a2 * b0 + nr * (a3 * b3)) % P,
        (a0 * b3 + a1 * b2 + a2 * b1 + a3 * b0) % P,
    )


def ext_scale_s(a, k: int):
    return tuple(mul_s(x, k % P) for x in a)


def ext_pow_s(a, e: int):
    acc, base = ONE_S, a
    while e:
        if e & 1:
            acc = ext_mul_s(acc, base)
        base = ext_mul_s(base, base)
        e >>= 1
    return acc


def ext_inv_s(a):
    """a^-1 by the norm map: a^-1 = (a^p a^p^2 a^p^3) / N(a)."""
    if all(x == 0 for x in a):
        raise ZeroDivisionError("inverse of zero in GF(p^4)")
    t = ext_mul_s(ext_frobenius_s(a, 1),
                  ext_mul_s(ext_frobenius_s(a, 2), ext_frobenius_s(a, 3)))
    norm = ext_mul_s(a, t)[0]
    return ext_scale_s(t, inv_s(norm))


# w^p = FROB_C * w with FROB_C = 11^((p-1)/4): the Frobenius maps multiply
# coordinate i by FROB_C^(i*k)
_FROB_C = pow(EXT_NONRESIDUE, (P - 1) // 4, P)
FROB_COEFFS = {k: tuple(pow(_FROB_C, (i * k) % 4, P) for i in range(4)) for k in (1, 2, 3)}


def ext_frobenius_s(a, k: int):
    return tuple(mul_s(x, c) for x, c in zip(a, FROB_COEFFS[k]))


def ext_powers_s(e, count: int) -> list:
    out, cur = [], ONE_S
    for _ in range(count):
        out.append(cur)
        cur = ext_mul_s(cur, e)
    return out


# ---------------------------------------------------------------------------
# Numpy host tables
# ---------------------------------------------------------------------------


def mul_np(a, b) -> np.ndarray:
    """Canonical product of uint32 arrays (the product is below 2^62)."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    return ((a * b) % np.uint64(P)).astype(np.uint32)


def powers_np(base: int, count: int) -> np.ndarray:
    """[1, b, ..., b^(count-1)] as uint32, by doubling."""
    out = np.ones(count, dtype=np.uint32)
    cur = 1
    while cur < count:
        step = min(cur, count - cur)
        out[cur : cur + step] = mul_np(out[:step], pow_s(base, cur))
        cur += step
    return out


# ---------------------------------------------------------------------------
# Tensor ops
# ---------------------------------------------------------------------------


def from_numpy(arr, device="cpu") -> torch.Tensor:
    """Canonical values (any integer numpy array) -> int32 tensor."""
    a = np.ascontiguousarray(np.asarray(arr).astype(np.int32))
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor of canonical words -> uint32 numpy array."""
    return t.detach().to("cpu").to(torch.int64).numpy().astype(np.uint32)


def _wide(x):
    return x.to(torch.int64) if isinstance(x, torch.Tensor) else int(x)


def _dtype(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor) and x.dtype == torch.int64:
            return torch.int64
    return DTYPE


def add(a, b):
    s = _wide(a) + _wide(b)
    return torch.where(s >= P, s - P, s).to(_dtype(a, b))


def sub(a, b):
    d = _wide(a) - _wide(b)
    return torch.where(d < 0, d + P, d).to(_dtype(a, b))


def neg(a):
    return sub(0, a)


def double(a):
    return add(a, a)


def mul(a, b):
    return ((_wide(a) * _wide(b)) % P).to(_dtype(a, b))


def sqr(a):
    return mul(a, a)


def pow_const(a, e: int):
    acc, base = None, a
    while e:
        if e & 1:
            acc = base if acc is None else mul(acc, base)
        e >>= 1
        if e:
            base = sqr(base)
    return torch.ones_like(a) if acc is None else acc


def inv(a):
    """Elementwise Fermat inverse a^(p-2); 0 maps to 0."""
    return pow_const(a, P - 2)


def powers(base: int, count: int, device, dtype=DTYPE) -> torch.Tensor:
    """[1, b, ..., b^(count-1)] on the device, by doubling."""
    out = torch.ones(1, dtype=torch.int64, device=device)
    while out.shape[0] < count:
        step = min(out.shape[0], count - out.shape[0])
        out = torch.cat([out, mul(out[:step], pow_s(base, out.shape[0]))])
    return out[:count].to(dtype)


def _coords(a):
    """The 4 coordinates of an ext operand, widened."""
    return [_wide(a[k]) for k in range(4)]


def ext_add(a, b):
    A, B = _coords(a), _coords(b)
    out = [A[k] + B[k] for k in range(4)]
    return torch.stack(torch.broadcast_tensors(*[torch.where(s >= P, s - P, s) for s in out])
                       ).to(_dtype(a, b))


def ext_sub(a, b):
    A, B = _coords(a), _coords(b)
    out = [A[k] - B[k] for k in range(4)]
    return torch.stack(torch.broadcast_tensors(*[torch.where(d < 0, d + P, d) for d in out])
                       ).to(_dtype(a, b))


def ext_mul(a, b):
    """Schoolbook product with w^4 = 11; each partial product is reduced
    before the sums, which keep every int64 below 2^38."""
    A, B = _coords(a), _coords(b)

    def m(i, j):
        return (A[i] * B[j]) % P

    nr = EXT_NONRESIDUE
    c0 = (m(0, 0) + nr * (m(1, 3) + m(2, 2) + m(3, 1))) % P
    c1 = (m(0, 1) + m(1, 0) + nr * (m(2, 3) + m(3, 2))) % P
    c2 = (m(0, 2) + m(1, 1) + m(2, 0) + nr * m(3, 3)) % P
    c3 = (m(0, 3) + m(1, 2) + m(2, 1) + m(3, 0)) % P
    return torch.stack(torch.broadcast_tensors(c0, c1, c2, c3)).to(_dtype(a, b))


def ext_scale(a, k):
    """ext * base: `k` a tensor broadcasting against a coordinate, or an int."""
    kw = _wide(k)
    return torch.stack(torch.broadcast_tensors(*[(x * kw) % P for x in _coords(a)])
                       ).to(_dtype(a, k))


def ext_from_base(x):
    z = torch.zeros_like(x)
    return torch.stack([x, z, z, z])


def ext_frobenius(a, k: int):
    return torch.stack([a[i] if c == 1 else mul(a[i], c)
                        for i, c in enumerate(FROB_COEFFS[k])])


def ext_inv(a):
    """Elementwise inverse of a (4, ...) tensor by the norm map: three
    Frobenius maps, two ext products, one base Fermat inverse."""
    t = ext_mul(ext_frobenius(a, 1), ext_mul(ext_frobenius(a, 2), ext_frobenius(a, 3)))
    A, T = _coords(a), _coords(t)
    s = ((A[1] * T[3]) % P + (A[2] * T[2]) % P + (A[3] * T[1]) % P) % P
    norm = ((A[0] * T[0]) % P + EXT_NONRESIDUE * s) % P
    return ext_scale(t, inv(norm)).to(_dtype(a))


def ext_prefix_product(a):
    """Inclusive prefix products of a (4, ..., n) tensor along the last
    axis, by log-depth doubling."""
    y = a
    n = a.shape[-1]
    shift = 1
    while shift < n:
        pad = torch.zeros_like(y[..., :shift])
        pad[0] = 1
        y = ext_mul(y, torch.cat([pad, y[..., :-shift]], dim=-1))
        shift <<= 1
    return y


def ext_powers(e, count: int, device, dtype=DTYPE) -> torch.Tensor:
    """(4, count) table of e^0, e^1, ... for a host ext scalar e, by
    doubling on the device."""
    out = torch.tensor([[1], [0], [0], [0]], dtype=torch.int64, device=device)
    while out.shape[1] < count:
        step = min(out.shape[1], count - out.shape[1])
        out = torch.cat([out, ext_mul(out[:, :step], ext_pow_s(e, out.shape[1]))], dim=1)
    return out[:, :count].to(dtype)
