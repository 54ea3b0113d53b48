"""Field-like op contexts: one gate definition, several execution contexts.

- ScalarOps    : python ints, base field (a gate's terms on host values)
- TensorOps    : int64 word tensors, base field (a gate or its captured
                 program over whole columns)
- ExtScalarOps : (int, int) tuples, GF(p^2) (the verifier at z)
"""

from ..field import extension as ext_f
from ..field import gl
from ..field import goldilocks as gf


class ScalarOps:
    @staticmethod
    def zero():
        return 0

    @staticmethod
    def one():
        return 1

    @staticmethod
    def constant(v: int):
        return v % gl.P

    add = staticmethod(gl.add)
    sub = staticmethod(gl.sub)
    mul = staticmethod(gl.mul)
    neg = staticmethod(gl.neg)

    @staticmethod
    def double(a):
        return gl.add(a, a)


class TensorOps:
    """Base-field ops over word tensors (constants stay python ints)."""

    @staticmethod
    def zero():
        return 0

    @staticmethod
    def one():
        return 1

    @staticmethod
    def constant(v: int):
        return v % gl.P

    add = staticmethod(gf.add)
    sub = staticmethod(gf.sub)
    mul = staticmethod(gf.mul)
    neg = staticmethod(gf.neg)
    double = staticmethod(gf.double)


class ExtScalarOps:
    @staticmethod
    def zero():
        return ext_f.ZERO_S

    @staticmethod
    def one():
        return ext_f.ONE_S

    @staticmethod
    def constant(v: int):
        return (v % gl.P, 0)

    add = staticmethod(ext_f.add_s)
    sub = staticmethod(ext_f.sub_s)
    mul = staticmethod(ext_f.mul_s)
    neg = staticmethod(ext_f.neg_s)

    @staticmethod
    def double(a):
        return ext_f.add_s(a, a)
