"""The gates of the JAX package's cs/gates/simple.py, with its constraints
(era-boojum's fma_gate_without_constant.rs, constant_allocator.rs,
boolean_allocator.rs, nop_gate.rs, public_input.rs, reduction_gate.rs,
reduction_by_powers_gate.rs, selection_gate.rs, parallel_selection.rs,
conditional_swap.rs, dot_product_gate.rs, quadratic_combination.rs,
zero_check.rs with and without its witness-column inverse, bounded_wrapper.rs,
lookup_marker.rs, simple_non_linearity_with_constant.rs,
matrix_multiplication_gate.rs, constants_allocator_as_explicit_constraint.rs).

A constructor allocates its outputs, registers their witness closure with
the system's resolver (with the JAX package's typed descriptor for the
native tape where it has one) and places the instance; values reduce
modulo the circuit's field (`cs.p`).
"""

from __future__ import annotations

from operator import mul

from ...field.spec import spec_of
from ...native import OP_CONST, OP_FMA, OP_REDUCTION
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
        d = cs.alloc_variable_without_value()
        p = cs.p
        ca, cc = coeff_ab % p, coeff_c % p
        coeffs = (ca, cc)
        cs.set_values_with_dependencies(
            (a, b, c), (d,), lambda v: [ca * v[0] * v[1] + cc * v[2]], (OP_FMA, coeffs))
        cs.place_gate(FmaGate.instance(), (a, b, c, d), coeffs)
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
        c = constants[0] if constants else 0
        v = cs.alloc_variable_without_value()
        cs.set_values_with_dependencies([], [v], lambda _: [c], (OP_CONST, (c,)))
        return [v]

    @staticmethod
    def allocate_constant(cs, value: int):
        value = value % cs.p
        v = cs.alloc_variable_without_value()
        cs.set_values_with_dependencies([], [v], lambda _: [value], (OP_CONST, (value,)))
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
        out = cs.alloc_variable_without_value()
        p = cs.p
        cf = tuple([c % p for c in coeffs4])
        cs.set_values_with_dependencies(
            list(vars4), [out], lambda v: [sum(map(mul, cf, v))], (OP_REDUCTION, cf))
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
        pads = []
        for v in row0:
            p = cs.alloc_variable_without_value()
            cs.resolver.set_value(p, v)
            pads.append(p)
        cs.bump_multiplicity(tid, 0)
        return pads

    @classmethod
    def instance(cls, width: int = 0):
        gate = cls._by_width.get(width)
        if gate is None:
            gate = cls._by_width[width] = cls(width)
        return gate


class BooleanConstraintGate(Gate):
    """x^2 = x."""

    name = "boolean"
    principal_width = 1
    num_terms = 1
    max_degree = 2

    def evaluate(self, ops, row, dst):
        x = row.v(0)
        dst.push(ops.sub(ops.mul(x, x), x))

    @staticmethod
    def enforce(cs, v):
        cs.place_gate(BooleanConstraintGate.instance(), (v,), ())
        return v

    @staticmethod
    def allocate(cs, witness_fn=None, ins=()):
        v = cs.alloc_variable_without_value()
        if witness_fn is not None:
            cs.set_values_with_dependencies(list(ins), [v], witness_fn)
        return BooleanConstraintGate.enforce(cs, v)


class ReductionByPowersGate(Gate):
    """Σ_i c^i·x_i = out over four terms, c the row's one constant."""

    name = "reduction_by_powers4"
    principal_width = 5
    num_constants = 1
    num_terms = 1
    max_degree = 1

    def evaluate(self, ops, row, dst):
        c = row.c(0)
        acc = row.v(0)
        cp = c
        for i in range(1, 4):
            acc = ops.add(acc, ops.mul(row.v(i), cp))
            cp = ops.mul(cp, c)
        dst.push(ops.sub(acc, row.v(4)))

    @staticmethod
    def reduce(cs, vars4, base):
        out = cs.alloc_variable_without_value()
        b = base % cs.p
        cs.set_values_with_dependencies(
            list(vars4), [out],
            lambda v: [sum(x * pow(b, i, cs.p) for i, x in enumerate(v))])
        cs.place_gate(ReductionByPowersGate.instance(), (*vars4, out), (b,))
        return out


class SelectionGate(Gate):
    """out = sel ? a : b, as sel·(a - b) + b - out."""

    name = "selection"
    principal_width = 4
    num_terms = 1
    max_degree = 2

    def evaluate(self, ops, row, dst):
        a, b, sel, out = row.v(0), row.v(1), row.v(2), row.v(3)
        t = ops.mul(sel, ops.sub(a, b))
        dst.push(ops.sub(ops.add(t, b), out))

    @staticmethod
    def select(cs, sel, a, b):
        out = cs.alloc_variable_without_value()
        cs.set_values_with_dependencies([a, b, sel], [out],
                                        lambda v: [v[0] if v[2] == 1 else v[1]])
        cs.place_gate(SelectionGate.instance(), (a, b, sel, out), ())
        return out


class ParallelSelectionGate(Gate):
    """Four selections under one selector: sel, then (a, b, out) four times."""

    name = "parallel_selection4"
    principal_width = 13
    num_terms = 4
    max_degree = 2

    def evaluate(self, ops, row, dst):
        sel = row.v(0)
        for i in range(4):
            a, b, out = row.v(1 + 3 * i), row.v(2 + 3 * i), row.v(3 + 3 * i)
            t = ops.mul(sel, ops.sub(a, b))
            dst.push(ops.sub(ops.add(t, b), out))

    @staticmethod
    def select(cs, sel, a_list, b_list):
        if len(a_list) != 4 or len(b_list) != 4:
            raise ValueError("parallel selection takes four pairs")
        outs = cs.alloc_multiple_variables_without_values(4)
        cs.set_values_with_dependencies(
            [sel, *a_list, *b_list], outs,
            lambda v: [a if v[0] == 1 else b for a, b in zip(v[1:5], v[5:9])])
        flat = [sel]
        for a, b, o in zip(a_list, b_list, outs):
            flat += [a, b, o]
        cs.place_gate(ParallelSelectionGate.instance(), flat, ())
        return outs


class ConditionalSwapGate(Gate):
    """(x, y) = sel ? (b, a) : (a, b)."""

    name = "conditional_swap"
    principal_width = 5
    num_terms = 2
    max_degree = 2

    def evaluate(self, ops, row, dst):
        sel, a, b, x, y = (row.v(i) for i in range(5))
        d = ops.mul(sel, ops.sub(b, a))
        dst.push(ops.sub(ops.add(a, d), x))
        dst.push(ops.add(ops.sub(b, d), ops.neg(y)))

    @staticmethod
    def swap(cs, sel, a, b):
        x, y = cs.alloc_multiple_variables_without_values(2)
        cs.set_values_with_dependencies(
            [sel, a, b], [x, y], lambda v: [v[2], v[1]] if v[0] == 1 else [v[1], v[2]])
        cs.place_gate(ConditionalSwapGate.instance(), (sel, a, b, x, y), ())
        return x, y


class DotProductGate(Gate):
    """Σ of four products = out."""

    name = "dot_product4"
    principal_width = 9
    num_terms = 1
    max_degree = 2

    def evaluate(self, ops, row, dst):
        acc = ops.zero()
        for i in range(4):
            acc = ops.add(acc, ops.mul(row.v(2 * i), row.v(2 * i + 1)))
        dst.push(ops.sub(acc, row.v(8)))

    @staticmethod
    def dot(cs, pairs):
        if len(pairs) != 4:
            raise ValueError("a dot product takes four pairs")
        out = cs.alloc_variable_without_value()
        flat = [v for pair in pairs for v in pair]
        cs.set_values_with_dependencies(
            flat, [out], lambda v: [sum(v[2 * i] * v[2 * i + 1] for i in range(4))])
        cs.place_gate(DotProductGate.instance(), (*flat, out), ())
        return out


class QuadraticCombinationGate(Gate):
    """Σ of four products = 0."""

    name = "quadratic_combination4"
    principal_width = 8
    num_terms = 1
    max_degree = 2

    def evaluate(self, ops, row, dst):
        acc = ops.zero()
        for i in range(4):
            acc = ops.add(acc, ops.mul(row.v(2 * i), row.v(2 * i + 1)))
        dst.push(acc)

    @staticmethod
    def enforce(cs, pairs):
        if len(pairs) != 4:
            raise ValueError("a quadratic combination takes four pairs")
        cs.place_gate(QuadraticCombinationGate.instance(),
                      [v for pair in pairs for v in pair], ())


class ZeroCheckGate(Gate):
    """out = (x == 0): x·out = 0 and 1 - out - x·aux = 0, the inverse aux in
    a copy column."""

    name = "zero_check"
    principal_width = 3
    num_terms = 2
    max_degree = 2

    def evaluate(self, ops, row, dst):
        x, out, aux = row.v(0), row.v(1), row.v(2)
        dst.push(ops.mul(x, out))
        dst.push(ops.sub(ops.sub(ops.one(), out), ops.mul(x, aux)))

    def padding_instance(self, cs, constants=()):
        return [cs.zero_var(), cs.one_var(), cs.zero_var()]

    @staticmethod
    def is_zero(cs, x):
        out, aux = cs.alloc_multiple_variables_without_values(2)
        cs.set_values_with_dependencies(
            [x], [out, aux], lambda v: [1, 0] if v[0] == 0 else [0, cs.inv(v[0])])
        cs.place_gate(ZeroCheckGate.instance(), (x, out, aux), ())
        return out


class BoundedGateWrapper(Gate):
    """An inner gate under a budget of rows: placement through the wrapper
    refuses to open a row past `max_rows`. It is a gate of its own name
    (bounded_<inner>), so its rows and selector are its own; its
    constraints are the inner gate's."""

    def __init__(self, inner: Gate, max_rows: int):
        self.inner = inner
        self.max_rows = max_rows
        self.name = f"bounded_{inner.name}"
        for attr in ("principal_width", "witness_width", "num_constants", "num_terms",
                     "max_degree"):
            setattr(self, attr, getattr(inner, attr))
        self._rows_used: set = set()

    def evaluate(self, ops, row, dst):
        return self.inner.evaluate(ops, row, dst)

    def padding_instance(self, cs, constants=()):
        return self.inner.padding_instance(cs, constants)

    def place(self, cs, var_places, constants=(), wit_places=()):
        """Place one instance; raises before touching the system when the
        instance would open a row past the budget."""
        tool = cs._tooling.get((self.name, tuple(constants)))
        opens_new_row = tool is None or tool[1] >= self.num_repetitions(cs.geometry)
        if opens_new_row and len(self._rows_used) >= self.max_rows:
            raise RuntimeError(
                f"bounded gate {self.inner.name}: row budget {self.max_rows} exceeded")
        off, row = cs.place_gate(self, var_places, constants, wit_places)
        self._rows_used.add(row)
        return off, row


class SimpleNonlinearityGate(Gate):
    """y = x^7 + c."""

    name = "nonlinearity7"
    principal_width = 2
    num_constants = 1
    num_terms = 1
    max_degree = 7

    def evaluate(self, ops, row, dst):
        x, y = row.v(0), row.v(1)
        x2 = ops.mul(x, x)
        x3 = ops.mul(x2, x)
        x4 = ops.mul(x2, x2)
        x7 = ops.mul(x4, x3)
        dst.push(ops.sub(ops.add(x7, row.c(0)), y))

    def padding_instance(self, cs, constants=()):
        c = constants[0] if constants else 0
        y = cs.alloc_variable_without_value()
        cs.set_values_with_dependencies([], [y], lambda _: [c])
        return [cs.zero_var(), y]

    @staticmethod
    def apply(cs, x, c: int):
        y = cs.alloc_variable_without_value()
        c = c % cs.p
        cs.set_values_with_dependencies([x], [y], lambda v: [pow(v[0], 7, cs.p) + c])
        cs.place_gate(SimpleNonlinearityGate.instance(), (x, y), (c,))
        return y


class MatrixMultiplicationGate(Gate):
    """out = M·in for an N×N matrix that is a parameter of the gate (the
    Poseidon MDS layers): gates of different matrices are different gates,
    named matmul_<name>. The entries are reduced modulo the prime of
    `field`, the circuit's."""

    num_constants = 0
    max_degree = 1

    def __init__(self, name: str, matrix, field: str = "goldilocks"):
        p = spec_of(field).p
        self.name = f"matmul_{name}"
        self.matrix = [[int(v) % p for v in r] for r in matrix]
        self.n = len(self.matrix)
        self.principal_width = 2 * self.n
        self.num_terms = self.n

    def evaluate(self, ops, row, dst):
        n = self.n
        for i in range(n):
            acc = ops.zero()
            for j in range(n):
                m = self.matrix[i][j]
                if m:
                    acc = ops.add(acc, ops.mul(ops.constant(m), row.v(j)))
            dst.push(ops.sub(acc, row.v(n + i)))

    def apply(self, cs, ins):
        if len(ins) != self.n:
            raise ValueError(f"{self.name} takes {self.n} inputs")
        outs = cs.alloc_multiple_variables_without_values(self.n)
        mat = self.matrix
        cs.set_values_with_dependencies(
            list(ins), outs, lambda v: [sum(m * x for m, x in zip(r, v)) for r in mat])
        cs.place_gate(self, [*ins, *outs], ())
        return outs


class ExplicitConstantsAllocatorGate(Gate):
    """Constants as constraints with the values baked into the gate, using
    no constant column: 0, 1 and -1 always, then a set of the caller's; a
    gate per set, named explicit_constants[<the set>]. The values are
    reduced modulo the prime of `field`, the circuit's."""

    witness_width = 0
    num_constants = 0
    max_degree = 1

    def __init__(self, constants_set=(), field: str = "goldilocks"):
        p = spec_of(field).p
        self.constants = [0, 1, p - 1] + [int(c) % p for c in constants_set]
        self.principal_width = self.num_terms = len(self.constants)
        self.name = ("explicit_constants["
                     + ",".join(str(c) for c in self.constants[3:]) + "]")

    def evaluate(self, ops, row, dst):
        for i, c in enumerate(self.constants):
            dst.push(ops.sub(row.v(i), ops.constant(c)))

    def padding_instance(self, cs, constants=()):
        vals = list(self.constants)
        places = cs.alloc_multiple_variables_without_values(len(vals))
        cs.set_values_with_dependencies([], places, lambda _: vals)
        return places

    @staticmethod
    def allocate(cs, constants_set=()):
        """Place one instance; returns {value: variable} for 0, 1, p - 1 and
        every value of constants_set."""
        gate = ExplicitConstantsAllocatorGate(constants_set, cs.field)
        variables = []
        for c in gate.constants:
            v = cs.alloc_variable_without_value()
            cs.set_values_with_dependencies([], [v], lambda _, c=c: [c])
            variables.append(v)
        cs.place_gate(gate, variables, ())
        return dict(zip(gate.constants, variables))


# the gates a name alone identifies; the parametrised gates
# (MatrixMultiplicationGate, ExplicitConstantsAllocatorGate,
# BoundedGateWrapper, u32.UIntXAddGate) are rebuilt from their parameters
# (compat.port_gate)
GATES_BY_NAME = {
    g.name: g
    for g in (FmaGate, ConstantsAllocatorGate, BooleanConstraintGate, NopGate,
              PublicInputGate, ReductionGate, ReductionByPowersGate, SelectionGate,
              ParallelSelectionGate, ConditionalSwapGate, DotProductGate,
              QuadraticCombinationGate, ZeroCheckGate, ZeroCheckWitnessGate,
              LookupMarkerGate, SimpleNonlinearityGate)
}
