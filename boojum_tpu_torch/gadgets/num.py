"""Num gadget, as in the JAX package's gadgets/num.py (era-boojum
gadgets/num): a field element in the circuit. Arithmetic is FMA and
Reduction gates, equality the ZeroCheck gate, and `spread_into_bits`
booleans with their binary recomposition."""

from __future__ import annotations

from ..cs.gates.simple import (
    BooleanConstraintGate,
    FmaGate,
    ReductionGate,
    SelectionGate,
    ZeroCheckGate,
)
from ..native import OP_SPLIT
from .boolean import Boolean


class Num:
    __slots__ = ("var",)

    def __init__(self, var: int):
        self.var = var

    @staticmethod
    def allocate(cs, value: int) -> "Num":
        return Num(cs.alloc_variable_with_value(value))

    @staticmethod
    def allocated_constant(cs, value: int) -> "Num":
        return Num(cs.allocate_constant(value))

    @staticmethod
    def zero(cs) -> "Num":
        return Num(cs.zero_var())

    @staticmethod
    def one(cs) -> "Num":
        return Num(cs.one_var())

    def get_value(self, cs) -> int:
        return cs.get_value(self.var)

    def add(self, cs, other: "Num") -> "Num":
        return Num(FmaGate.fma(cs, cs.one_var(), self.var, other.var, 1, 1))

    def sub(self, cs, other: "Num") -> "Num":
        return Num(FmaGate.fma(cs, cs.one_var(), other.var, self.var, cs.p - 1, 1))

    def mul(self, cs, other: "Num") -> "Num":
        return Num(FmaGate.fma(cs, self.var, other.var, cs.zero_var(), 1, 0))

    def square(self, cs) -> "Num":
        return self.mul(cs, self)

    def mul_by_constant(self, cs, k: int) -> "Num":
        return Num(FmaGate.fma(cs, cs.one_var(), self.var, cs.zero_var(), k, 0))

    def add_constant(self, cs, k: int) -> "Num":
        return Num(FmaGate.fma(cs, cs.one_var(), cs.one_var(), self.var, k, 1))

    def fma(self, cs, other: "Num", addend: "Num", c0=1, c1=1) -> "Num":
        return Num(FmaGate.fma(cs, self.var, other.var, addend.var, c0, c1))

    @staticmethod
    def linear_combination(cs, nums, coeffs) -> "Num":
        """Σ coeff_i·num_i through chained Reduction gates."""
        if len(nums) != len(coeffs) or not nums:
            raise ValueError("one coefficient a term, at least one term")
        acc = None
        items = [(n.var, c % cs.p) for n, c in zip(nums, coeffs)]
        while items:
            chunk, items = items[:3], items[3:]
            vars4 = [v for v, _ in chunk]
            cf = [c for _, c in chunk]
            if acc is not None:
                vars4 = [acc] + vars4
                cf = [1] + cf
            while len(vars4) < 4:
                vars4.append(cs.zero_var())
                cf.append(0)
            acc = ReductionGate.reduce(cs, vars4, cf)
        return Num(acc)

    def is_zero(self, cs) -> Boolean:
        return Boolean(ZeroCheckGate.is_zero(cs, self.var))

    def equals(self, cs, other: "Num") -> Boolean:
        return self.sub(cs, other).is_zero(cs)

    @staticmethod
    def select(cs, flag: Boolean, a: "Num", b: "Num") -> "Num":
        return Num(SelectionGate.select(cs, flag.var, a.var, b.var))

    def mask(self, cs, flag: Boolean) -> "Num":
        """flag ? self : 0."""
        return Num(FmaGate.fma(cs, self.var, flag.var, cs.zero_var(), 1, 0))

    def spread_into_bits(self, cs, num_bits: int) -> list:
        """Little-endian booleans b_i with Σ b_i·2^i = self."""
        from .chunk_utils import enforce_chunk_recomposition

        bits = cs.alloc_multiple_variables_without_values(num_bits)
        cs.set_values_with_dependencies(
            [self.var], bits, lambda v: [(v[0] >> i) & 1 for i in range(num_bits)],
            (OP_SPLIT, (1,)))
        for b in bits:
            BooleanConstraintGate.enforce(cs, b)
        enforce_chunk_recomposition(cs, bits, self.var, bits_per_chunk=1)
        return [Boolean(b) for b in bits]
