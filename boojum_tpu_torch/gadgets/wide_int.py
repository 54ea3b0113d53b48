"""Wide unsigned integers as vectors of u32 limbs, as in the JAX package's
gadgets/wide_int.py (era-boojum gadgets/u160, u256, u512): UInt160,
UInt256 and UInt512 with carry chains over the U32 gates, the widening
u256 product over the U32 FMA gate, byte casts, masks and equality. Limb
ranges come from the 4-bit chunk lookups (`decompose_and_check`), carries
from the u32 gates. Every gate here needs 32-bit values as field elements,
so a BabyBear circuit refuses them (cs/gates/u32.py)."""

from __future__ import annotations

from ..cs.gates.simple import ReductionGate
from ..cs.gates.u32 import U32AddGate, U32FmaGate, U32SubGate
from .boolean import Boolean
from .chunk_utils import decompose_and_check
from .num import Num
from .uint import UInt32


class UIntWide:
    """Little-endian vector of NUM_LIMBS UInt32 limbs; a subclass sets
    NUM_LIMBS."""

    NUM_LIMBS = 0
    __slots__ = ("limbs",)

    def __init__(self, limbs):
        if len(limbs) != self.NUM_LIMBS:
            raise ValueError(f"{type(self).__name__} takes {self.NUM_LIMBS} limbs")
        self.limbs = list(limbs)

    @property
    def BITS(self):
        return 32 * self.NUM_LIMBS

    @classmethod
    def _check_range(cls, value: int):
        if not 0 <= value < 1 << (32 * cls.NUM_LIMBS):
            raise ValueError(f"{value} is not a {32 * cls.NUM_LIMBS}-bit value")

    @classmethod
    def allocate_checked(cls, cs, value: int):
        cls._check_range(value)
        return cls([UInt32.allocate_checked(cs, (value >> (32 * i)) & 0xFFFFFFFF)
                    for i in range(cls.NUM_LIMBS)])

    @classmethod
    def allocated_constant(cls, cs, value: int):
        cls._check_range(value)
        return cls([UInt32.allocated_constant(cs, (value >> (32 * i)) & 0xFFFFFFFF)
                    for i in range(cls.NUM_LIMBS)])

    @classmethod
    def zero(cls, cs):
        return cls.allocated_constant(cs, 0)

    def get_value(self, cs) -> int:
        return sum(limb.get_value(cs) << (32 * i) for i, limb in enumerate(self.limbs))

    def overflowing_add(self, cs, other):
        """(self + other mod 2^BITS, carry-out Boolean): a u32 carry chain."""
        _same_width(self, other)
        carry, out = cs.zero_var(), []
        for a, b in zip(self.limbs, other.limbs):
            c, carry = U32AddGate.add(cs, a.var, b.var, carry)
            decompose_and_check(cs, c, 32)
            out.append(UInt32(c))
        return type(self)(out), Boolean(carry)

    def overflowing_sub(self, cs, other):
        """(self - other mod 2^BITS, borrow-out Boolean)."""
        _same_width(self, other)
        borrow, out = cs.zero_var(), []
        for a, b in zip(self.limbs, other.limbs):
            c, borrow = U32SubGate.sub(cs, a.var, b.var, borrow)
            decompose_and_check(cs, c, 32)
            out.append(UInt32(c))
        return type(self)(out), Boolean(borrow)

    def is_zero(self, cs) -> Boolean:
        """Σ limbs == 0 (the limbs are below 2^32, their sum far below p)."""
        total = Num.linear_combination(cs, [limb.into_num() for limb in self.limbs],
                                       [1] * self.NUM_LIMBS)
        return total.is_zero(cs)

    @staticmethod
    def equals(cs, a, b) -> Boolean:
        _same_width(a, b)
        diff, borrow = a.overflowing_sub(cs, b)
        return diff.is_zero(cs).and_(cs, borrow.negate(cs))

    def mask(self, cs, flag: Boolean):
        """flag ? self : 0."""
        cs.zero_var()  # the JAX gadget allocates it first: keeps the rows alike
        return type(self)([UInt32(Num(limb.var).mask(cs, flag).var) for limb in self.limbs])

    def mask_negated(self, cs, flag: Boolean):
        return self.mask(cs, flag.negate(cs))

    @staticmethod
    def select(cs, flag: Boolean, a, b):
        _same_width(a, b)
        return type(a)([UInt32.select(cs, flag, la, lb) for la, lb in zip(a.limbs, b.limbs)])

    @classmethod
    def from_le_bytes(cls, cs, bytes_le):
        if len(bytes_le) != 4 * cls.NUM_LIMBS:
            raise ValueError(f"{cls.__name__} takes {4 * cls.NUM_LIMBS} bytes")
        return cls([UInt32(ReductionGate.reduce(cs, [x.var for x in bytes_le[4 * i:4 * i + 4]],
                                                [1, 1 << 8, 1 << 16, 1 << 24]))
                    for i in range(cls.NUM_LIMBS)])

    @classmethod
    def from_be_bytes(cls, cs, bytes_be):
        return cls.from_le_bytes(cs, list(reversed(bytes_be)))

    def to_le_bytes(self, cs):
        return [b for limb in self.limbs for b in limb.to_le_bytes(cs)]

    def to_be_bytes(self, cs):
        return list(reversed(self.to_le_bytes(cs)))

    def div2(self, cs):
        """(self >> 1, the low bit as a Boolean): x = 2·y + b through the u32
        add gate limb by limb, 2·y_i + c_i = x_i + 2^32·c_(i+1), c_0 = b."""
        n = self.NUM_LIMBS
        ys = cs.alloc_multiple_variables_without_values(n)
        bit = cs.alloc_variable_without_value()

        def resolve(vals):
            x = sum(v << (32 * i) for i, v in enumerate(vals))
            return [((x >> 1) >> (32 * i)) & 0xFFFFFFFF for i in range(n)] + [x & 1]

        cs.set_values_with_dependencies([limb.var for limb in self.limbs], [*ys, bit], resolve)
        Boolean.from_variable_checked(cs, bit)
        carry = bit
        for i in range(n):
            if i + 1 < n:
                cout = cs.alloc_variable_without_value()
                cs.set_values_with_dependencies([ys[i], carry], [cout],
                                                lambda v: [(2 * v[0] + v[1]) >> 32])
            else:
                cout = cs.zero_var()
            cs.place_gate(U32AddGate.instance(), [ys[i], ys[i], carry, self.limbs[i].var, cout],
                          ())
            decompose_and_check(cs, ys[i], 32)
            carry = cout
        return type(self)([UInt32(y) for y in ys]), Boolean(bit)

    def is_odd(self, cs) -> Boolean:
        return self.div2(cs)[1]


def _same_width(a, b):
    if type(a) is not type(b):
        raise TypeError(f"{type(a).__name__} against {type(b).__name__}")


class UInt160(UIntWide):
    NUM_LIMBS = 5


class UInt256(UIntWide):
    NUM_LIMBS = 8

    def widening_mul(self, cs, other: "UInt256") -> "UInt512":
        """The 512-bit product, schoolbook over u32 limbs: row i adds
        a_i·b_j into the running limbs through the u32 FMA gate's (low,
        high) split."""
        n = self.NUM_LIMBS
        res = [cs.zero_var()] * (2 * n)
        for i in range(n):
            carry = cs.zero_var()
            for j in range(n):
                low, high = U32FmaGate.fma(cs, self.limbs[i].var, other.limbs[j].var,
                                           res[i + j], carry)
                decompose_and_check(cs, low, 32)
                decompose_and_check(cs, high, 32)
                res[i + j], carry = low, high
            res[i + n] = carry
        return UInt512([UInt32(v) for v in res])


class UInt512(UIntWide):
    NUM_LIMBS = 16

    def to_low(self) -> UInt256:
        return UInt256(self.limbs[:8])

    def to_high(self) -> UInt256:
        return UInt256(self.limbs[8:])
