"""Field-like op contexts: one gate definition, several execution contexts.

- ScalarOps    : python ints, base field (a gate's terms on host values)
- TensorOps    : int64 word tensors, base field (a gate or its captured
                 program over whole columns)
- ExtScalarOps : (int, int) tuples, GF(p^2) (the verifier at z)
- BBTensorOps, BBExtScalarOps : the BabyBear twins of TensorOps (the
                 BabyBear quotient sweep) and of ExtScalarOps over
                 GF(p^4) 4-tuples (the quotient identity at z)
"""

from ..field import babybear as bb
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


class BBTensorOps:
    """BabyBear base-field ops over word tensors (constants stay ints)."""

    @staticmethod
    def zero():
        return 0

    @staticmethod
    def one():
        return 1

    @staticmethod
    def constant(v: int):
        return v % bb.P

    add = staticmethod(bb.add)
    sub = staticmethod(bb.sub)
    mul = staticmethod(bb.mul)
    neg = staticmethod(bb.neg)
    double = staticmethod(bb.double)


class BBExtScalarOps:
    @staticmethod
    def zero():
        return bb.ZERO_S

    @staticmethod
    def one():
        return bb.ONE_S

    @staticmethod
    def constant(v: int):
        return bb.ext_from_base_s(v)

    add = staticmethod(bb.ext_add_s)
    sub = staticmethod(bb.ext_sub_s)
    mul = staticmethod(bb.ext_mul_s)
    neg = staticmethod(bb.ext_neg_s)

    @staticmethod
    def double(a):
        return bb.ext_add_s(a, a)
