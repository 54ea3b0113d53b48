"""The FMA gate over the quadratic extension, of the JAX package's
cs/gates/ext_fma.py (era-boojum
fma_gate_in_extension_without_constant.rs, `compute_fma_in_extension`
:368, the inversion constraint :427): c0·a·b + c1·c = d over
GF(p^2) = GF(p)[w]/(w^2 - 7), with a, b, c and d as (c0, c1) pairs of base
variables and the coefficients as four constants a row. Two quotient
terms, degree 3.
"""

from __future__ import annotations

from ...field import extension as ext_f
from ...field import gl
from .base import Gate

NON_RESIDUE = 7


def _ext_mul_ops(ops, a, b):
    """(a0 + a1·w)(b0 + b1·w) over base field-like ops."""
    c0 = ops.add(ops.mul(a[0], b[0]), ops.mul(ops.constant(NON_RESIDUE), ops.mul(a[1], b[1])))
    c1 = ops.add(ops.mul(a[0], b[1]), ops.mul(a[1], b[0]))
    return (c0, c1)


class ExtFmaGate(Gate):
    name = "ext_fma"
    principal_width = 8  # a0 a1 b0 b1 c0 c1 d0 d1
    num_constants = 4  # coeff_ab (2), coeff_c (2)
    num_terms = 2
    max_degree = 3

    def evaluate(self, ops, row, dst):
        a, b, c, d = ((row.v(2 * i), row.v(2 * i + 1)) for i in range(4))
        k0 = (row.c(0), row.c(1))
        k1 = (row.c(2), row.c(3))
        t = _ext_mul_ops(ops, _ext_mul_ops(ops, k0, a), b)
        u = _ext_mul_ops(ops, k1, c)
        dst.push(ops.sub(ops.add(t[0], u[0]), d[0]))
        dst.push(ops.sub(ops.add(t[1], u[1]), d[1]))

    @staticmethod
    def fma(cs, a, b, c, coeff_ab=(1, 0), coeff_c=(1, 0)):
        """Allocate and constrain d = coeff_ab·a·b + coeff_c·c; the operands
        are (var, var) pairs, the coefficients host (int, int) pairs."""
        k0 = (coeff_ab[0] % gl.P, coeff_ab[1] % gl.P)
        k1 = (coeff_c[0] % gl.P, coeff_c[1] % gl.P)
        d = cs.alloc_multiple_variables_without_values(2)

        def resolve(vals):
            av, bv, cv = (vals[0], vals[1]), (vals[2], vals[3]), (vals[4], vals[5])
            return list(ext_f.add_s(ext_f.mul_s(ext_f.mul_s(k0, av), bv), ext_f.mul_s(k1, cv)))

        cs.set_values_with_dependencies([a[0], a[1], b[0], b[1], c[0], c[1]], d, resolve)
        cs.place_gate(ExtFmaGate.instance(), [a[0], a[1], b[0], b[1], c[0], c[1], *d],
                      k0 + k1)
        return tuple(d)

    @staticmethod
    def inversion(cs, a):
        """The inverse of a as a witness, with a·a_inv = 1 enforced through
        this gate (era-boojum create_inversion_constraint)."""
        inv = cs.alloc_multiple_variables_without_values(2)
        cs.set_values_with_dependencies([a[0], a[1]], inv,
                                        lambda vals: list(ext_f.inv_s((vals[0], vals[1]))))
        one, zero = cs.one_var(), cs.zero_var()
        # coeff_ab·a·inv + 0·c = (1, 0), with d pinned to the constants
        cs.place_gate(ExtFmaGate.instance(), [a[0], a[1], *inv, zero, zero, one, zero],
                      (1, 0, 0, 0))
        return tuple(inv)
