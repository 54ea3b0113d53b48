"""The gates of the fma-chain and sha256 circuits, with the constraints of
the JAX package's cs/gates/simple.py (era-boojum's
fma_gate_without_constant.rs, constant_allocator.rs, nop_gate.rs,
public_input.rs, reduction_gate.rs).

Synthesis resolves every value eagerly as a host int: a constructor computes
its outputs and places the instance.
"""

from __future__ import annotations

from ...field import gl
from .base import Gate


class FmaGate(Gate):
    """c0·a·b + c1·c = d."""

    name = "fma"
    principal_width = 4
    num_constants = 2
    num_terms = 1
    max_degree = 3

    def evaluate(self, ops, row, dst):
        a, b, c, d = row.v(0), row.v(1), row.v(2), row.v(3)
        c0, c1 = row.c(0), row.c(1)
        t = ops.mul(c0, ops.mul(a, b))
        t = ops.add(t, ops.mul(c1, c))
        dst.push(ops.sub(t, d))

    @staticmethod
    def fma(cs, a, b, c, coeff_ab=1, coeff_c=1):
        """Allocate and constrain d = coeff_ab·a·b + coeff_c·c."""
        ca, cc = coeff_ab % gl.P, coeff_c % gl.P
        val = cs.values
        value = (ca * val[a >> 1] * val[b >> 1] + cc * val[c >> 1]) % gl.P
        d = cs.alloc_variable_with_value(value)
        cs.place_gate(FmaGate.instance(), (a, b, c, d), (ca, cc))
        return d

    @staticmethod
    def enforce_fma(cs, a, b, c, d, coeff_ab=1, coeff_c=1):
        """Constrain coeff_ab·a·b + coeff_c·c = d over existing variables."""
        cs.place_gate(FmaGate.instance(), (a, b, c, d),
                      (coeff_ab % gl.P, coeff_c % gl.P))


class ConstantsAllocatorGate(Gate):
    """v = const, one constant per row shared by every instance."""

    name = "constant"
    principal_width = 1
    num_constants = 1
    num_terms = 1
    max_degree = 1

    def evaluate(self, ops, row, dst):
        dst.push(ops.sub(row.v(0), row.c(0)))

    def padding_instance(self, cs, constants=()):
        return [cs.alloc_variable_with_value(constants[0] if constants else 0)]

    @staticmethod
    def allocate_constant(cs, value: int):
        value = value % gl.P
        v = cs.alloc_variable_with_value(value)
        cs.place_gate(ConstantsAllocatorGate.instance(), (v,), (value,))
        return v


class NopGate(Gate):
    """Row filler: padding rows carry this gate."""

    name = "nop"

    def evaluate(self, ops, row, dst):
        pass


class PublicInputGate(Gate):
    """Exposes a variable as a public input. No quotient term: the opening
    is enforced in the DEEP phase by (w_col(x) - value)/(x - omega^row)."""

    name = "public_input"
    principal_width = 1

    def evaluate(self, ops, row, dst):
        pass

    @staticmethod
    def place(cs, v):
        col, row = cs.place_gate(PublicInputGate.instance(), (v,), ())
        cs.set_public(col, row)
        return v


class ReductionGate(Gate):
    """Σ_i coeff_i·x_i = out over four terms."""

    name = "reduction4"
    principal_width = 5
    num_constants = 4
    num_terms = 1
    max_degree = 1

    def evaluate(self, ops, row, dst):
        acc = ops.zero()
        for i in range(4):
            acc = ops.add(acc, ops.mul(row.v(i), row.c(i)))
        dst.push(ops.sub(acc, row.v(4)))

    @staticmethod
    def reduce(cs, vars4, coeffs4):
        """Allocate and constrain out = Σ coeffs4[i]·vars4[i]."""
        cf = tuple(c % gl.P for c in coeffs4)
        val = cs.values
        value = sum(c * val[v >> 1] for v, c in zip(vars4, cf)) % gl.P
        out = cs.alloc_variable_with_value(value)
        cs.place_gate(ReductionGate.instance(), (*vars4, out), cf)
        return out

    @staticmethod
    def enforce_reduce(cs, vars4, coeffs4, out):
        """Constrain Σ coeffs4[i]·vars4[i] = out over existing variables."""
        cs.place_gate(ReductionGate.instance(), (*vars4, out),
                      tuple(c % gl.P for c in coeffs4))


GATES_BY_NAME = {
    g.name: g
    for g in (FmaGate, ConstantsAllocatorGate, NopGate, PublicInputGate, ReductionGate)
}
