"""The fixed-width integer gates of the JAX package's cs/gates/u32.py
(era-boojum u32_add.rs, u32_sub.rs, u32_fma.rs,
u32_tri_add_carry_as_chunk.rs, uintx_add.rs), with its constraints.

The gates enforce the carry arithmetic; the limbs' ranges come from lookups
placed by the gadgets. Every gate needs each value of its width to be a
distinct field element, so synthesizing one over BabyBear raises.
"""

from __future__ import annotations

from ...native import OP_BYTE_TRIADD, OP_TRIADD, OP_U32_ADD, OP_U32_FMA, OP_U32_SUB
from .base import Gate

SHIFT32 = 1 << 32


def _require_capacity(cs, bits: int, gate_name: str) -> None:
    cs.require_field_bits(bits, f"{gate_name} (fixed-width integer arithmetic)")


class U32AddGate(Gate):
    """a + b + carry_in = c + 2^32·carry_out; carry_out boolean."""

    name = "u32_add"
    principal_width = 5
    num_terms = 2
    max_degree = 2

    def evaluate(self, ops, row, dst):
        a, b, cin, c, cout = (row.v(i) for i in range(5))
        lhs = ops.add(ops.add(a, b), cin)
        rhs = ops.add(c, ops.mul(ops.constant(SHIFT32), cout))
        dst.push(ops.sub(lhs, rhs))
        dst.push(ops.sub(ops.mul(cout, cout), cout))

    @staticmethod
    def add(cs, a, b, carry_in):
        _require_capacity(cs, 32, "U32AddGate")
        c, cout = cs.alloc_multiple_variables_without_values(2)
        cs.set_values_with_dependencies(
            [a, b, carry_in], [c, cout],
            lambda v: [sum(v) & 0xFFFFFFFF, sum(v) >> 32], (OP_U32_ADD, (32,)))
        cs.place_gate(U32AddGate.instance(), (a, b, carry_in, c, cout), ())
        return c, cout


class U32SubGate(Gate):
    """a - b - borrow_in = c - 2^32·borrow_out; borrow_out boolean."""

    name = "u32_sub"
    principal_width = 5
    num_terms = 2
    max_degree = 2

    def evaluate(self, ops, row, dst):
        a, b, bin_, c, bout = (row.v(i) for i in range(5))
        lhs = ops.sub(ops.sub(a, b), bin_)
        rhs = ops.sub(c, ops.mul(ops.constant(SHIFT32), bout))
        dst.push(ops.sub(lhs, rhs))
        dst.push(ops.sub(ops.mul(bout, bout), bout))

    @staticmethod
    def sub(cs, a, b, borrow_in):
        _require_capacity(cs, 32, "U32SubGate")
        c, bout = cs.alloc_multiple_variables_without_values(2)

        def resolve(v):
            d = v[0] - v[1] - v[2]
            return [d + SHIFT32, 1] if d < 0 else [d, 0]

        cs.set_values_with_dependencies([a, b, borrow_in], [c, bout], resolve,
                                        (OP_U32_SUB, ()))
        cs.place_gate(U32SubGate.instance(), (a, b, borrow_in, c, bout), ())
        return c, bout


class U32FmaGate(Gate):
    """a·b + c + carry_in = low + 2^32·high, sound in Goldilocks through the
    operands' 16-bit halves, so that no constraint reaches p.

    Cells: a, b, c, cin, a_lo, a_hi, b_lo, b_hi, low, high, k; terms:
      a - a_lo - 2^16·a_hi;  b - b_lo - 2^16·b_hi;
      a_lo·b_lo + c + cin + 2^16·(a_lo·b_hi + a_hi·b_lo) - low - 2^32·k;
      a_hi·b_hi + k - high.
    fma() range-checks the halves (16 bits) and k (20 bits); the caller
    range-checks low and high.
    """

    name = "u32_fma"
    principal_width = 11
    num_terms = 4
    max_degree = 2

    def evaluate(self, ops, row, dst):
        a, b, c, cin, a_lo, a_hi, b_lo, b_hi, low, high, k = (
            row.v(i) for i in range(11))
        sh16 = ops.constant(1 << 16)
        dst.push(ops.sub(a, ops.add(a_lo, ops.mul(sh16, a_hi))))
        dst.push(ops.sub(b, ops.add(b_lo, ops.mul(sh16, b_hi))))
        mid = ops.add(ops.mul(a_lo, b_hi), ops.mul(a_hi, b_lo))
        lhs = ops.add(ops.add(ops.mul(a_lo, b_lo), c), cin)
        lhs = ops.add(lhs, ops.mul(sh16, mid))
        rhs = ops.add(low, ops.mul(ops.constant(SHIFT32), k))
        dst.push(ops.sub(lhs, rhs))
        dst.push(ops.sub(ops.add(ops.mul(a_hi, b_hi), k), high))

    @staticmethod
    def fma(cs, a, b, c, carry_in):
        from ...gadgets.chunk_utils import decompose_and_check

        _require_capacity(cs, 32, "U32FmaGate")
        outs = cs.alloc_multiple_variables_without_values(7)
        a_lo, a_hi, b_lo, b_hi, low, high, k = outs

        def resolve(v):
            av, bv, cv, cinv = v
            s = av * bv + cv + cinv
            alo, ahi, blo, bhi = av & 0xFFFF, av >> 16, bv & 0xFFFF, bv >> 16
            part = alo * blo + cv + cinv + ((alo * bhi + ahi * blo) << 16)
            return [alo, ahi, blo, bhi, s & 0xFFFFFFFF, s >> 32, part >> 32]

        cs.set_values_with_dependencies([a, b, c, carry_in], outs, resolve,
                                        (OP_U32_FMA, ()))
        cs.place_gate(U32FmaGate.instance(), (a, b, c, carry_in, *outs), ())
        for half in (a_lo, a_hi, b_lo, b_hi):
            decompose_and_check(cs, half, 16)
        decompose_and_check(cs, k, 20)
        return low, high


class U32TriAddCarryAsChunkGate(Gate):
    """a + b + c = low + 2^32·high, high a chunk the caller range-checks."""

    name = "u32_tri_add"
    principal_width = 5
    num_terms = 1
    max_degree = 1

    def evaluate(self, ops, row, dst):
        a, b, c, low, high = (row.v(i) for i in range(5))
        lhs = ops.add(ops.add(a, b), c)
        rhs = ops.add(low, ops.mul(ops.constant(SHIFT32), high))
        dst.push(ops.sub(lhs, rhs))

    @staticmethod
    def add(cs, a, b, c):
        _require_capacity(cs, 32, "U32TriAddCarryAsChunkGate")
        low, high = cs.alloc_multiple_variables_without_values(2)
        cs.set_values_with_dependencies(
            [a, b, c], [low, high], lambda v: [sum(v) & 0xFFFFFFFF, sum(v) >> 32],
            (OP_TRIADD, ()))
        cs.place_gate(U32TriAddCarryAsChunkGate.instance(), (a, b, c, low, high), ())
        return low, high


class ByteTriAddGate(Gate):
    """Three u32 operands as little-endian bytes:
    Σ_i (a_i + b_i + x_i - out_i)·2^(8i) - 2^32·carry = 0. The operands are
    never composed; the caller's lookups range-check the output bytes and
    the carry."""

    name = "byte_tri_add"
    principal_width = 17
    num_terms = 1
    max_degree = 1

    def evaluate(self, ops, row, dst):
        acc = None
        for i in range(4):
            w = ops.constant(1 << (8 * i))
            s = ops.add(ops.add(row.v(i), row.v(4 + i)), row.v(8 + i))
            s = ops.sub(s, row.v(12 + i))
            term = ops.mul(w, s)
            acc = term if acc is None else ops.add(acc, term)
        acc = ops.sub(acc, ops.mul(ops.constant(SHIFT32), row.v(16)))
        dst.push(acc)

    @staticmethod
    def add(cs, a4, b4, x4):
        """(the four bytes of (a + b + x) mod 2^32, the carry)."""
        _require_capacity(cs, 32, "ByteTriAddGate")
        outs = cs.alloc_multiple_variables_without_values(4)
        carry = cs.alloc_variable_without_value()
        ins = [*a4, *b4, *x4]

        def resolve(v):
            s = sum(b << (8 * (i % 4)) for i, b in enumerate(v))
            return [(s >> (8 * i)) & 0xFF for i in range(4)] + [s >> 32]

        cs.set_values_with_dependencies(ins, [*outs, carry], resolve, (OP_BYTE_TRIADD, ()))
        cs.place_gate(ByteTriAddGate.instance(), [*ins, *outs, carry], ())
        return outs, carry


class UIntXAddGate(Gate):
    """a + b + carry_in = c + 2^W·carry_out for W in {8, 16, 32}, named
    uint<W>_add."""

    principal_width = 5
    num_terms = 2
    max_degree = 2

    def __init__(self, width_bits: int):
        if width_bits not in (8, 16, 32):
            raise ValueError("UIntXAddGate takes 8, 16 or 32 bits")
        self.width_bits = width_bits
        self.name = f"uint{width_bits}_add"
        self.shift = 1 << width_bits

    def evaluate(self, ops, row, dst):
        a, b, cin, c, cout = (row.v(i) for i in range(5))
        lhs = ops.add(ops.add(a, b), cin)
        rhs = ops.add(c, ops.mul(ops.constant(self.shift), cout))
        dst.push(ops.sub(lhs, rhs))
        dst.push(ops.sub(ops.mul(cout, cout), cout))

    def add(self, cs, a, b, carry_in):
        _require_capacity(cs, self.width_bits, "UIntXAddGate")
        c, cout = cs.alloc_multiple_variables_without_values(2)
        mask, bits = self.shift - 1, self.width_bits
        cs.set_values_with_dependencies(
            [a, b, carry_in], [c, cout], lambda v: [sum(v) & mask, sum(v) >> bits],
            (OP_U32_ADD, (bits,)))
        cs.place_gate(self, (a, b, carry_in, c, cout), ())
        return c, cout


GATES_BY_NAME = {
    g.name: g
    for g in (U32AddGate, U32SubGate, U32FmaGate, U32TriAddCarryAsChunkGate,
              ByteTriAddGate)
}
