"""The field-like ops contract over circuit variables, as in the JAX
package's gadgets/field_like_circuit.py (era-boojum's NumAsFieldWrapper and
NumExtAsFieldWrapper, gadgets/num/prime_field_like.rs): the same duck type
that runs gate evaluators over ints, tensors and verifier openings
(cs/field_like.py), here emitting gates, so that a verifier's formulas run
inside a circuit: `gate.evaluate(CircuitExtOps(cs), row_of_opening_vars,
dst)` re-emits an inner circuit's quotient terms as constraints.

Base ops are FMA gates; extension ops are pairs (c0, c1) over
GF(p)[w]/(w^2 - 7), the schoolbook product in four FMA gates. That
extension is Goldilocks's (BabyBear draws from GF(p^4)), so a BabyBear
circuit is refused (`require_goldilocks`).
"""

from __future__ import annotations

from ..cs.gates.simple import FmaGate, SelectionGate
from ..field import extension as ext_f
from .non_native_field import require_goldilocks

NON_RESIDUE = 7


class CircuitOps:
    """Base-field ops over the variables of one constraint system."""

    def __init__(self, cs):
        require_goldilocks(cs, "CircuitOps")
        self.cs = cs

    def zero(self):
        return self.cs.zero_var()

    def one(self):
        return self.cs.one_var()

    def constant(self, v: int):
        return self.cs.allocate_constant(v % self.cs.p)

    def add(self, a, b):
        return FmaGate.fma(self.cs, self.one(), a, b, 1, 1)

    def sub(self, a, b):
        return FmaGate.fma(self.cs, self.one(), b, a, self.cs.p - 1, 1)

    def mul(self, a, b):
        return FmaGate.fma(self.cs, a, b, self.zero(), 1, 0)

    def neg(self, a):
        return FmaGate.fma(self.cs, self.one(), a, self.zero(), self.cs.p - 1, 0)

    def double(self, a):
        return FmaGate.fma(self.cs, self.one(), a, self.zero(), 2, 0)

    def fma(self, a, b, c, ca=1, cc=1):
        """ca·a·b + cc·c."""
        return FmaGate.fma(self.cs, a, b, c, ca, cc)

    def mul_by_constant(self, a, k: int):
        return FmaGate.fma(self.cs, self.one(), a, self.zero(), k, 0)

    def enforce_equal(self, a, b):
        """a - b = 0 as one FMA row: 0·1·a + 1·b = a."""
        FmaGate.enforce_fma(self.cs, self.one(), a, b, a, 0, 1)

    def enforce_zero(self, a):
        FmaGate.enforce_fma(self.cs, self.one(), a, self.zero(), a, 0, 0)

    def inv(self, a):
        """A witness inverse with a·a_inv = 1 enforced (a nonzero input: a
        verifier's denominators)."""
        cs = self.cs
        iv = cs.alloc_variable_without_value()
        cs.set_values_with_dependencies([a], [iv], lambda v: [cs.inv(v[0])])
        FmaGate.enforce_fma(cs, a, iv, self.zero(), self.one(), 1, 0)
        return iv

    def select(self, flag, a, b):
        return SelectionGate.select(self.cs, flag, a, b)


class CircuitExtOps:
    """GF(p^2) ops over (c0, c1) variable pairs; w^2 = 7."""

    def __init__(self, cs):
        self.cs = cs
        self.base = CircuitOps(cs)

    def zero(self):
        z = self.cs.zero_var()
        return (z, z)

    def one(self):
        return (self.cs.one_var(), self.cs.zero_var())

    def constant(self, v: int):
        return (self.cs.allocate_constant(v % self.cs.p), self.cs.zero_var())

    def from_base_constants(self, c0: int, c1: int):
        return (self.cs.allocate_constant(c0 % self.cs.p),
                self.cs.allocate_constant(c1 % self.cs.p))

    def from_base_var(self, v):
        return (v, self.cs.zero_var())

    def add(self, a, b):
        return (self.base.add(a[0], b[0]), self.base.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.base.sub(a[0], b[0]), self.base.sub(a[1], b[1]))

    def neg(self, a):
        return (self.base.neg(a[0]), self.base.neg(a[1]))

    def double(self, a):
        return (self.base.double(a[0]), self.base.double(a[1]))

    def mul(self, a, b):
        """(a0 + a1 w)(b0 + b1 w): c0 = a0 b0 + 7 a1 b1, c1 = a0 b1 + a1 b0,
        four FMA gates."""
        t = self.base.fma(a[0], b[0], self.cs.zero_var(), 1, 0)
        c0 = self.base.fma(a[1], b[1], t, NON_RESIDUE, 1)
        u = self.base.fma(a[0], b[1], self.cs.zero_var(), 1, 0)
        c1 = self.base.fma(a[1], b[0], u, 1, 1)
        return (c0, c1)

    def mul_by_base(self, a, b_var):
        return (self.base.mul(a[0], b_var), self.base.mul(a[1], b_var))

    def mul_by_base_constant(self, a, k: int):
        return (self.base.mul_by_constant(a[0], k), self.base.mul_by_constant(a[1], k))

    def inv(self, a):
        """A witness inverse with a·a_inv = 1 enforced."""
        cs = self.cs
        iv0 = cs.alloc_variable_without_value()
        iv1 = cs.alloc_variable_without_value()
        cs.set_values_with_dependencies([a[0], a[1]], [iv0, iv1],
                                        lambda v: list(ext_f.inv_s((v[0], v[1]))))
        prod = self.mul(a, (iv0, iv1))
        self.base.enforce_equal(prod[0], cs.one_var())
        self.base.enforce_zero(prod[1])
        return (iv0, iv1)

    def pow(self, a, e: int):
        """Square and multiply, a circuit product a step."""
        if e < 0:
            raise ValueError("negative exponent")
        if e == 0:
            return self.one()
        result = None
        cur = a
        while e:
            if e & 1:
                result = cur if result is None else self.mul(result, cur)
            e >>= 1
            if e:
                cur = self.mul(cur, cur)
        return result

    def enforce_equal(self, a, b):
        self.base.enforce_equal(a[0], b[0])
        self.base.enforce_equal(a[1], b[1])

    def select(self, flag, a, b):
        return (self.base.select(flag, a[0], b[0]), self.base.select(flag, a[1], b[1]))

    def get_value(self, a):
        return (self.cs.get_value(a[0]), self.cs.get_value(a[1]))
