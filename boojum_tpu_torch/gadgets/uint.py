"""UInt8, UInt16 and UInt32 gadgets, as in the JAX package's gadgets/uint.py
(era-boojum gadgets/u8, u16, u32): ranges come from 4-bit chunk lookups
against TriXor4 (booleans without lookups), carries from the UIntXAdd and
U32 gates."""

from __future__ import annotations

from ..cs.gates.simple import ReductionGate, SelectionGate
from ..cs.gates.u32 import U32AddGate, U32FmaGate, U32SubGate, UIntXAddGate
from ..native import OP_SPLIT
from .boolean import Boolean
from .chunk_utils import decompose_and_check
from .num import Num


class UIntX:
    """What the widths share; a subclass sets WIDTH."""

    WIDTH = 0
    __slots__ = ("var",)

    def __init__(self, var: int):
        self.var = var

    @classmethod
    def _check_range(cls, value: int):
        if not 0 <= value < (1 << cls.WIDTH):
            raise ValueError(f"{value} is not a {cls.WIDTH}-bit value")

    @classmethod
    def allocate_checked(cls, cs, value: int) -> "UIntX":
        cls._check_range(value)
        v = cs.alloc_variable_with_value(value)
        decompose_and_check(cs, v, cls.WIDTH)
        return cls(v)

    @classmethod
    def allocated_constant(cls, cs, value: int) -> "UIntX":
        cls._check_range(value)
        return cls(cs.allocate_constant(value))

    @classmethod
    def from_variable_checked(cls, cs, var: int) -> "UIntX":
        decompose_and_check(cs, var, cls.WIDTH)
        return cls(var)

    def get_value(self, cs) -> int:
        return cs.get_value(self.var)

    def into_num(self) -> Num:
        return Num(self.var)

    def add(self, cs, other):
        """(sum, carry-out boolean)."""
        if self.WIDTH == 32:
            c, cout = U32AddGate.add(cs, self.var, other.var, cs.zero_var())
        else:
            c, cout = UIntXAddGate(self.WIDTH).add(cs, self.var, other.var, cs.zero_var())
        decompose_and_check(cs, c, self.WIDTH)
        return type(self)(c), Boolean(cout)

    def sub(self, cs, other):
        """(difference, borrow-out boolean); 32 bits only."""
        if self.WIDTH != 32:
            raise NotImplementedError("the sub gate is 32-bit")
        c, bout = U32SubGate.sub(cs, self.var, other.var, cs.zero_var())
        decompose_and_check(cs, c, self.WIDTH)
        return type(self)(c), Boolean(bout)

    @staticmethod
    def select(cs, flag: Boolean, a, b):
        if type(a) is not type(b):
            raise TypeError("select takes two values of one width")
        return type(a)(SelectionGate.select(cs, flag.var, a.var, b.var))


class UInt8(UIntX):
    WIDTH = 8


class UInt16(UIntX):
    WIDTH = 16


class UInt32(UIntX):
    WIDTH = 32

    @staticmethod
    def from_be_bytes(cs, bytes4) -> "UInt32":
        """Four UInt8, big-endian, as one u32."""
        return UInt32(ReductionGate.reduce(cs, [b.var for b in bytes4],
                                           [1 << 24, 1 << 16, 1 << 8, 1]))

    def to_le_bytes(self, cs) -> list:
        """Four checked UInt8, little-endian."""
        outs = cs.alloc_multiple_variables_without_values(4)
        cs.set_values_with_dependencies(
            [self.var], outs, lambda v: [(v[0] >> (8 * i)) & 0xFF for i in range(4)],
            (OP_SPLIT, (8,)))
        ReductionGate.enforce_reduce(cs, outs, [1, 1 << 8, 1 << 16, 1 << 24], self.var)
        return [UInt8.from_variable_checked(cs, o) for o in outs]

    def fma(self, cs, other: "UInt32", addend: "UInt32"):
        """(low, high) of self·other + addend."""
        low, high = U32FmaGate.fma(cs, self.var, other.var, addend.var, cs.zero_var())
        decompose_and_check(cs, low, 32)
        decompose_and_check(cs, high, 32)
        return UInt32(low), UInt32(high)
