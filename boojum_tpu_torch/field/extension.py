"""Quadratic extension GF(p^2) = GF(p)[w] / (w^2 - 7).

Tensor elements are pairs (c0, c1) of int64 word tensors (or python ints for
a constant operand); host scalars are `(int, int)` tuples (functions
suffixed `_s`). Every Fiat-Shamir challenge drawn after the witness
commitment lives here.
"""

import torch

from . import gl
from . import goldilocks as gf

NON_RESIDUE = 7


def add(a, b):
    return (gf.add(a[0], b[0]), gf.add(a[1], b[1]))


def sub(a, b):
    return (gf.sub(a[0], b[0]), gf.sub(a[1], b[1]))


def mul(a, b):
    # (a0 + a1 w)(b0 + b1 w) = a0 b0 + 7 a1 b1 + (a0 b1 + a1 b0) w
    v0 = gf.mul(a[0], b[0])
    v1 = gf.mul(a[1], b[1])
    c0 = gf.add(v0, gf.mul_small(v1, NON_RESIDUE))
    c1 = gf.add(gf.mul(a[0], b[1]), gf.mul(a[1], b[0]))
    return (c0, c1)


def mul_by_base(a, b):
    return (gf.mul(a[0], b), gf.mul(a[1], b))


def batch_inverse(a):
    """Elementwise inverse along the last axis with one base-field batch
    inversion of the norms: 1/(c0 + c1 w) = (c0 - c1 w) / (c0^2 - 7 c1^2)."""
    d = gf.sub(gf.sqr(a[0]), gf.mul_small(gf.sqr(a[1]), NON_RESIDUE))
    dinv = gf.batch_inverse(d)
    return (gf.mul(a[0], dinv), gf.neg(gf.mul(a[1], dinv)))


def prefix_product(a):
    """Inclusive prefix product of an ext pair along the last axis."""
    c0, c1 = a
    n = c0.shape[-1]
    shift = 1
    while shift < n:
        s0 = torch.ones_like(c0)
        s1 = torch.zeros_like(c1)
        s0[..., shift:] = c0[..., :-shift]
        s1[..., shift:] = c1[..., :-shift]
        c0, c1 = mul((c0, c1), (s0, s1))
        shift *= 2
    return (c0, c1)


# ---------------------------------------------------------------------------
# Host scalar ((int, int) tuple) ops
# ---------------------------------------------------------------------------

ZERO_S = (0, 0)
ONE_S = (1, 0)


def add_s(a, b):
    return (gl.add(a[0], b[0]), gl.add(a[1], b[1]))


def sub_s(a, b):
    return (gl.sub(a[0], b[0]), gl.sub(a[1], b[1]))


def neg_s(a):
    return (gl.neg(a[0]), gl.neg(a[1]))


def mul_s(a, b):
    v0 = gl.mul(a[0], b[0])
    v1 = gl.mul(a[1], b[1])
    c0 = gl.add(v0, gl.mul(v1, NON_RESIDUE))
    c1 = gl.add(gl.mul(a[0], b[1]), gl.mul(a[1], b[0]))
    return (c0, c1)


def mul_by_base_s(a, b: int):
    return (gl.mul(a[0], b), gl.mul(a[1], b))


def sqr_s(a):
    return mul_s(a, a)


def inv_s(a):
    d = gl.sub(gl.sqr(a[0]), gl.mul(gl.sqr(a[1]), NON_RESIDUE))
    dinv = gl.inv(d)
    return (gl.mul(a[0], dinv), gl.neg(gl.mul(a[1], dinv)))


def pow_s(a, e: int):
    result = ONE_S
    base = a
    e = int(e)
    while e:
        if e & 1:
            result = mul_s(result, base)
        e >>= 1
        base = sqr_s(base)
    return result


def powers_s(base, count: int):
    base = (int(base[0]), int(base[1]))
    out = [ONE_S] * count
    for i in range(1, count):
        out[i] = mul_s(out[i - 1], base)
    return out
