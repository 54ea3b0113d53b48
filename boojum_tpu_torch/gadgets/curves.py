"""Short-Weierstrass curve gadgets over non-native fields, as in the JAX
package's gadgets/curves.py (era-boojum gadgets/curves: sw_projective,
zeroable_affine): projective points with the complete addition and doubling
formulas of Renes, Costello and Batina (eprint 2015/1060) for a = 0 curves
(secp256k1, BN254), and an affine point with an explicit identity flag."""

from __future__ import annotations

from ..cs.gates.simple import FmaGate
from .boolean import Boolean
from .non_native_field import NNFParams, NonNativeField


class SWProjectivePoint:
    """(X : Y : Z) on y^2 = x^3 + b, a = 0."""

    __slots__ = ("x", "y", "z", "params", "curve_b")

    def __init__(self, x, y, z, curve_b: int):
        self.x = x
        self.y = y
        self.z = z
        self.params = x.params
        self.curve_b = curve_b

    @classmethod
    def from_xy_unchecked(cls, cs, x: NonNativeField, y: NonNativeField, curve_b: int):
        return cls(x, y, NonNativeField.one(cs, x.params), curve_b)

    @classmethod
    def zero(cls, cs, params: NNFParams, curve_b: int):
        """The identity (0 : 1 : 0)."""
        return cls(NonNativeField.zero(cs, params), NonNativeField.one(cs, params),
                   NonNativeField.zero(cs, params), curve_b)

    def negated(self, cs) -> "SWProjectivePoint":
        return SWProjectivePoint(self.x, self.y.negated(cs), self.z, self.curve_b)

    def _b3(self, cs) -> NonNativeField:
        return NonNativeField.allocated_constant(
            cs, (3 * self.curve_b) % self.params.modulus, self.params)

    def double(self, cs) -> "SWProjectivePoint":
        """Complete doubling, a = 0 (2015/1060 algorithm 9)."""
        x, y, z = self.x, self.y, self.z
        b3 = self._b3(cs)
        t0 = y.square(cs)
        z3 = t0.add(cs, t0)
        z3 = z3.add(cs, z3)
        z3 = z3.add(cs, z3)
        t1 = y.mul(cs, z)
        t2 = z.square(cs)
        t2 = b3.mul(cs, t2)
        x3 = t2.mul(cs, z3)
        y3 = t0.add(cs, t2)
        z3 = t1.mul(cs, z3)
        t1 = t2.add(cs, t2)
        t2 = t1.add(cs, t2)
        t0 = t0.sub(cs, t2)
        y3 = t0.mul(cs, y3)
        y3 = x3.add(cs, y3)
        t1 = x.mul(cs, y)
        x3 = t0.mul(cs, t1)
        x3 = x3.add(cs, x3)
        return SWProjectivePoint(x3, y3, z3, self.curve_b)

    def add_mixed(self, cs, ax: NonNativeField, ay: NonNativeField):
        """self + (ax, ay), the affine point not the identity (2015/1060
        algorithm 8, a = 0); self may be any point."""
        x1, y1, z1 = self.x, self.y, self.z
        b3 = self._b3(cs)
        t0 = x1.mul(cs, ax)
        t1 = y1.mul(cs, ay)
        t3 = ax.add(cs, ay)
        t4 = x1.add(cs, y1)
        t3 = t3.mul(cs, t4)
        t4 = t0.add(cs, t1)
        t3 = t3.sub(cs, t4)
        t4 = ay.mul(cs, z1)
        t4 = t4.add(cs, y1)
        y3 = ax.mul(cs, z1)
        y3 = y3.add(cs, x1)
        x3 = t0.add(cs, t0)
        t0 = x3.add(cs, t0)
        t2 = b3.mul(cs, z1)
        z3 = t1.add(cs, t2)
        t1 = t1.sub(cs, t2)
        y3 = b3.mul(cs, y3)
        x3 = t4.mul(cs, y3)
        t2 = t3.mul(cs, t1)
        x3 = t2.sub(cs, x3)
        y3 = y3.mul(cs, t0)
        t1 = t1.mul(cs, z3)
        y3 = t1.add(cs, y3)
        t0 = t0.mul(cs, t3)
        z3 = z3.mul(cs, t4)
        z3 = z3.add(cs, t0)
        return SWProjectivePoint(x3, y3, z3, self.curve_b)

    def sub_mixed(self, cs, ax: NonNativeField, ay: NonNativeField):
        return self.add_mixed(cs, ax, ay.negated(cs))

    def convert_to_affine_or_default(self, cs, default_x: int, default_y: int):
        """((x, y), at_infinity): affine coordinates through a witness
        inverse of z, or (default_x, default_y) where z = 0."""
        params = self.params
        at_inf = self.z.is_zero(cs)
        # z where it is nonzero, else 1, so that the inverse exists
        one = NonNativeField.one(cs, params)
        z_inv = NonNativeField.select(cs, at_inf, one, self.z).inv(cs)
        x_aff = self.x.mul(cs, z_inv)
        y_aff = self.y.mul(cs, z_inv)
        dx = NonNativeField.allocated_constant(cs, default_x, params)
        dy = NonNativeField.allocated_constant(cs, default_y, params)
        return ((NonNativeField.select(cs, at_inf, dx, x_aff),
                 NonNativeField.select(cs, at_inf, dy, y_aff)), at_inf)

    def enforce_on_curve(self, cs):
        """Y^2·Z = X^3 + b·Z^3, the projective curve equation."""
        params = self.params
        b_c = NonNativeField.allocated_constant(cs, self.curve_b, params)
        lhs = self.y.square(cs).mul(cs, self.z)
        x3 = self.x.square(cs).mul(cs, self.x)
        z3 = self.z.square(cs).mul(cs, self.z)
        rhs = x3.add(cs, b_c.mul(cs, z3))
        flag = lhs.sub(cs, rhs).is_zero(cs)
        FmaGate.enforce_fma(cs, cs.one_var(), flag.var, cs.one_var(), cs.one_var(), 1, 0)


class ZeroableAffinePoint:
    """An affine point with an explicit is-infinity flag."""

    __slots__ = ("x", "y", "is_infinity")

    def __init__(self, x: NonNativeField, y: NonNativeField, is_infinity: Boolean):
        self.x = x
        self.y = y
        self.is_infinity = is_infinity
