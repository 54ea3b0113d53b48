"""Boolean gadget, as in the JAX package's gadgets/boolean.py (era-boojum
gadgets/boolean): a variable held to {0, 1} by the x^2 = x gate; each logic
op is FMA gates over the arithmetic forms and: a·b, or: a + b - a·b,
xor: a + b - 2ab, not: 1 - a."""

from __future__ import annotations

from ..cs.gates.simple import BooleanConstraintGate, FmaGate, SelectionGate


class Boolean:
    __slots__ = ("var",)

    def __init__(self, var: int):
        self.var = var

    @staticmethod
    def allocate(cs, value: bool) -> "Boolean":
        v = cs.alloc_variable_with_value(1 if value else 0)
        BooleanConstraintGate.enforce(cs, v)
        return Boolean(v)

    @staticmethod
    def allocated_constant(cs, value: bool) -> "Boolean":
        return Boolean(cs.one_var() if value else cs.zero_var())

    @staticmethod
    def from_variable_checked(cs, var: int) -> "Boolean":
        BooleanConstraintGate.enforce(cs, var)
        return Boolean(var)

    def get_value(self, cs) -> bool:
        return cs.get_value(self.var) == 1

    def and_(self, cs, other: "Boolean") -> "Boolean":
        return Boolean(FmaGate.fma(cs, self.var, other.var, cs.zero_var(), 1, 0))

    def or_(self, cs, other: "Boolean") -> "Boolean":
        t = FmaGate.fma(cs, self.var, other.var, cs.zero_var(), 1, 0)
        s = FmaGate.fma(cs, cs.one_var(), self.var, other.var, 1, 1)
        return Boolean(FmaGate.fma(cs, cs.one_var(), t, s, cs.p - 1, 1))

    def xor(self, cs, other: "Boolean") -> "Boolean":
        s = FmaGate.fma(cs, cs.one_var(), self.var, other.var, 1, 1)
        return Boolean(FmaGate.fma(cs, self.var, other.var, s, cs.p - 2, 1))

    def negate(self, cs) -> "Boolean":
        return Boolean(FmaGate.fma(cs, cs.one_var(), self.var, cs.one_var(), cs.p - 1, 1))

    @staticmethod
    def select(cs, flag: "Boolean", a: "Boolean", b: "Boolean") -> "Boolean":
        return Boolean(SelectionGate.select(cs, flag.var, a.var, b.var))

    @staticmethod
    def multi_and(cs, bools) -> "Boolean":
        acc = bools[0]
        for b in bools[1:]:
            acc = acc.and_(cs, b)
        return acc

    @staticmethod
    def multi_or(cs, bools) -> "Boolean":
        acc = bools[0]
        for b in bools[1:]:
            acc = acc.or_(cs, b)
        return acc
