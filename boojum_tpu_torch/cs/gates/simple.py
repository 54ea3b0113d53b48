"""The gates of the port's circuits, with the constraints of the JAX
package's cs/gates/simple.py (era-boojum's fma_gate_without_constant.rs,
constant_allocator.rs, nop_gate.rs, public_input.rs, reduction_gate.rs,
zero_check.rs with its witness-column inverse, lookup_marker.rs).

Synthesis resolves every value eagerly as a host int: a constructor computes
its outputs and places the instance, reducing modulo the circuit's field
(`cs.p`).
"""

from __future__ import annotations

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
        ca, cc = coeff_ab % cs.p, coeff_c % cs.p
        val = cs.values
        value = (ca * val[a >> 1] * val[b >> 1] + cc * val[c >> 1]) % cs.p
        d = cs.alloc_variable_with_value(value)
        cs.place_gate(FmaGate.instance(), (a, b, c, d), (ca, cc))
        return d

    @staticmethod
    def enforce_fma(cs, a, b, c, d, coeff_ab=1, coeff_c=1):
        """Constrain coeff_ab·a·b + coeff_c·c = d over existing variables."""
        cs.place_gate(FmaGate.instance(), (a, b, c, d),
                      (coeff_ab % cs.p, coeff_c % cs.p))


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
        value = value % cs.p
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
        cf = tuple(c % cs.p for c in coeffs4)
        val = cs.values
        value = sum(c * val[v >> 1] for v, c in zip(vars4, cf)) % cs.p
        out = cs.alloc_variable_with_value(value)
        cs.place_gate(ReductionGate.instance(), (*vars4, out), cf)
        return out

    @staticmethod
    def enforce_reduce(cs, vars4, coeffs4, out):
        """Constrain Σ coeffs4[i]·vars4[i] = out over existing variables."""
        cs.place_gate(ReductionGate.instance(), (*vars4, out),
                      tuple(c % cs.p for c in coeffs4))


class ZeroCheckWitnessGate(Gate):
    """out = (x == 0): x·out = 0 and 1 - out - x·aux = 0, the inverse aux in
    a witness column (era-boojum zero_check.rs with
    use_witness_column_for_inversion): no copy constraint wires it."""

    name = "zero_check_wit"
    principal_width = 2
    witness_width = 1
    num_terms = 2
    max_degree = 2

    def evaluate(self, ops, row, dst):
        x, out, aux = row.v(0), row.v(1), row.w(0)
        dst.push(ops.mul(x, out))
        dst.push(ops.sub(ops.sub(ops.one(), out), ops.mul(x, aux)))

    def padding_instance(self, cs, constants=()):
        # x = 0, out = 1; the vacant witness cell is 0
        return [cs.zero_var(), cs.one_var()]

    @staticmethod
    def is_zero(cs, x):
        """Allocate and constrain out = 1 if x == 0 else 0."""
        out = cs.alloc_variable_without_value()
        aux = cs.alloc_witness_without_value()
        cs.set_values_with_dependencies(
            [x], [out, aux], lambda v: [1, 0] if v[0] == 0 else [0, cs.inv(v[0])])
        cs.place_gate(ZeroCheckWitnessGate.instance(), (x, out), (), wit_places=(aux,))
        return out


class LookupMarkerGate(Gate):
    """Marks rows whose general copy columns hold lookup tuples (era-boojum
    LookupFormalGate, lookup_marker.rs): `width` columns per tuple, the table
    id as the row's one gate constant. Its selector gates the A relations of
    the lookup argument; it has no quotient terms of its own."""

    name = "lookup_marker"
    num_constants = 1
    is_lookup_marker = True
    _by_width: dict = {}

    def __init__(self, width: int):
        self.principal_width = width

    def evaluate(self, ops, row, dst):
        pass

    def padding_instance(self, cs, constants=()):
        """A vacant instance takes fresh variables valued as the table's row
        0 (zero-padded to the width), and counts that row once more."""
        tid = int(constants[0])
        table = cs.get_table(tid)
        row0 = [int(v) for v in table.content[0]]
        row0 += [0] * (self.principal_width - table.width)
        cs.bump_multiplicity(tid, 0)
        return [cs.alloc_variable_with_value(v) for v in row0]

    @classmethod
    def instance(cls, width: int = 0):
        gate = cls._by_width.get(width)
        if gate is None:
            gate = cls._by_width[width] = cls(width)
        return gate


GATES_BY_NAME = {
    g.name: g
    for g in (FmaGate, ConstantsAllocatorGate, NopGate, PublicInputGate, ReductionGate,
              ZeroCheckWitnessGate, LookupMarkerGate)
}
