"""Non-native field arithmetic over 16-bit limbs, as in the JAX package's
gadgets/non_native_field.py (era-boojum gadgets/non_native_field,
implementation_u16.rs): elements of a foreign prime field (the secp256k1
base and scalar fields, BN254's base field) as vectors of 16-bit limb
variables.

Every operation enforces one integer congruence EXPR = q·m + r through a
carry chain over the limb columns,

  Σ_k (expr_k − (q·m)_k − r_k)·2^(16k) = 0,

checked column by column with signed carries in offset form (carry + 2^22,
range-checked to 24 bits). Each column stays far below the field's modulus,
so equality in the field is equality of integers, and the telescoped chain
with a zero final carry proves the congruence. The products of `mul` are
FMA variables; the (q·m)_k terms have constant coefficients (m is fixed), so
reduction gates carry them. Results come out as fresh 16-bit limbs below
2^(16·N), not necessarily below m: `enforce_reduced` makes a value
canonical where it must be.

The carry bounds assume 64-bit columns, so a circuit over BabyBear is
refused (`require_goldilocks`); over Goldilocks the words are the JAX
package's.
"""

from __future__ import annotations

from ..cs.gates.simple import FmaGate, ReductionGate, SelectionGate
from ..cs.gates.u32 import UIntXAddGate
from .boolean import Boolean
from .chunk_utils import decompose_and_check
from .num import Num

LIMB_BITS = 16
LIMB = 1 << LIMB_BITS
CARRY_OFFSET_BITS = 22  # |carry| < 2^22 with at most 33 products of 2^32 a column
CARRY_CHECK_BITS = 24  # offset carries are range-checked to this many bits
# the columns' carry bounds hold where every 63-bit value is a field element
FIELD_BITS = 63


def require_goldilocks(cs, feature: str = "NonNativeField") -> None:
    """Refuse a circuit whose field cannot hold the limb columns' sums."""
    cs.require_field_bits(FIELD_BITS, f"{feature} (16-bit limb columns whose carry "
                                      f"bounds assume 64-bit field elements)")


class NNFParams:
    def __init__(self, modulus: int, name: str = "nnf"):
        self.modulus = modulus
        self.name = name
        self.num_limbs = (modulus.bit_length() + LIMB_BITS - 1) // LIMB_BITS
        self.m_limbs = _limbs_of(modulus, self.num_limbs)


def _limbs_of(value: int, n: int):
    return [(value >> (LIMB_BITS * i)) & (LIMB - 1) for i in range(n)]


def _checked_limbs(cs, values):
    """Fresh variables of `values`, each range-checked to 16 bits."""
    out = []
    for lv in values:
        v = cs.alloc_variable_with_value(lv)
        decompose_and_check(cs, v, LIMB_BITS)
        out.append(v)
    return out


class _LinAcc:
    """Σ coeff·var + const, built as a chain of reduction gates."""

    def __init__(self, cs):
        self.cs = cs
        self.items: list = []
        self.const = 0

    def add_term(self, var, coeff: int):
        c = coeff % self.cs.p
        if c:
            self.items.append((var, c))

    def add_const(self, v: int):
        self.const = (self.const + v) % self.cs.p

    def build(self):
        cs = self.cs
        items = list(self.items)
        if self.const:
            items.append((cs.one_var(), self.const))
        if not items:
            return cs.zero_var()
        acc = None
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
        return acc

    def enforce_zero(self):
        """As the JAX package places it: the FMA row 0·1·v + 1·0 = 0, which
        holds for every v, so v is not pinned to zero. Kept so that the two
        packages' assemblies agree; a fix changes both (ROADMAP.md, §C)."""
        cs = self.cs
        v = self.build()
        FmaGate.enforce_fma(cs, cs.one_var(), v, cs.zero_var(), cs.zero_var(), 0, 1)


def _enforce_congruence(cs, columns, q_limbs, r_limbs, params):
    """Enforce Σ columns_k·2^(16k) = q·m + Σ r_k·2^(16k) as integers.
    columns[k] = ([(var, coeff), ...], constant), each column's value
    bounded well below p; q_limbs and r_limbs are 16-bit-checked
    variables."""
    n = params.num_limbs
    p = cs.p
    num_cols = max(len(columns), len(q_limbs) + n - 1, n)
    offset = 1 << CARRY_OFFSET_BITS
    prev_s = None  # the offset carry entering the column
    for k in range(num_cols):
        acc = _LinAcc(cs)
        if k < len(columns):
            terms, const = columns[k]
            for var, coeff in terms:
                acc.add_term(var, coeff)
            acc.add_const(const)
        for i, qv in enumerate(q_limbs):  # - (q·m)_k
            j = k - i
            if 0 <= j < n and params.m_limbs[j]:
                acc.add_term(qv, -params.m_limbs[j])
        if k < len(r_limbs):  # - r_k
            acc.add_term(r_limbs[k], -1)
        if prev_s is not None:  # + carry_in = s_prev - 2^B
            acc.add_term(prev_s, 1)
            acc.add_const(-offset)
        if k == num_cols - 1:  # the final carry is zero
            acc.enforce_zero()
            break
        # - 2^16·carry_out, carry_out = s - 2^B
        s = cs.alloc_variable_without_value()

        def resolve(vals, terms=list(acc.items), const=acc.const):
            total = const % p
            for (_var, coeff), v in zip(terms, vals):
                total = (total + coeff * v) % p
            if total > p // 2:  # a small signed integer around 0
                total -= p
            if total % LIMB:
                raise ArithmeticError("congruence column not divisible by 2^16")
            return [(total // LIMB + offset) % p]

        cs.set_values_with_dependencies([v for v, _ in acc.items], [s], resolve)
        decompose_and_check(cs, s, CARRY_CHECK_BITS)
        acc.add_term(s, -LIMB)
        acc.add_const(LIMB * offset)
        acc.enforce_zero()
        prev_s = s


def _product_columns(cs, a_limbs, b_limbs):
    """The limb products a_i·b_j (FMA variables), grouped by column i + j."""
    n = len(a_limbs)
    columns = [([], 0) for _ in range(2 * n - 1)]
    for i in range(n):
        for j in range(n):
            pv = FmaGate.fma(cs, a_limbs[i], b_limbs[j], cs.zero_var(), 1, 0)
            columns[i + j][0].append((pv, 1))
    return columns


class NonNativeField:
    """A foreign-field element as 16-bit limb variables."""

    __slots__ = ("limbs", "params")

    def __init__(self, limbs, params: NNFParams):
        if len(limbs) != params.num_limbs:
            raise ValueError(f"{params.name} takes {params.num_limbs} limbs")
        self.limbs = list(limbs)
        self.params = params

    @classmethod
    def allocate_checked(cls, cs, value: int, params: NNFParams):
        require_goldilocks(cs)
        if not 0 <= value < params.modulus:
            raise ValueError(f"{value} is not an element of {params.name}")
        return cls(_checked_limbs(cs, _limbs_of(value, params.num_limbs)), params)

    @classmethod
    def allocated_constant(cls, cs, value: int, params: NNFParams):
        require_goldilocks(cs)
        if not 0 <= value < 1 << (LIMB_BITS * params.num_limbs):
            raise ValueError(f"{value} does not fit {params.num_limbs} limbs")
        return cls([cs.allocate_constant(lv) for lv in _limbs_of(value, params.num_limbs)],
                   params)

    @classmethod
    def zero(cls, cs, params: NNFParams):
        return cls.allocated_constant(cs, 0, params)

    @classmethod
    def one(cls, cs, params: NNFParams):
        return cls.allocated_constant(cs, 1, params)

    def get_raw_value(self, cs) -> int:
        return sum(cs.get_value(v) << (LIMB_BITS * i) for i, v in enumerate(self.limbs))

    def get_value(self, cs) -> int:
        return self.get_raw_value(cs) % self.params.modulus

    def _alloc_result(self, cs, value: int, num_q: int, q_value: int):
        """Fresh 16-bit-checked limbs of the remainder `value`, then of the
        quotient q_value over num_q limbs."""
        if not 0 <= q_value < 1 << (LIMB_BITS * num_q):
            raise ArithmeticError("quotient overflow")
        r_limbs = _checked_limbs(cs, _limbs_of(value, self.params.num_limbs))
        return r_limbs, _checked_limbs(cs, _limbs_of(q_value, num_q))

    def add(self, cs, other: "NonNativeField") -> "NonNativeField":
        p = self.params
        q, r = divmod(self.get_raw_value(cs) + other.get_raw_value(cs), p.modulus)
        r_limbs, q_limbs = self._alloc_result(cs, r, 2, q)
        columns = [([(self.limbs[k], 1), (other.limbs[k], 1)], 0) for k in range(p.num_limbs)]
        _enforce_congruence(cs, columns, q_limbs, r_limbs, p)
        return NonNativeField(r_limbs, p)

    def sub(self, cs, other: "NonNativeField") -> "NonNativeField":
        """a - b as a + (2·m) - b, the digits of 2·m redistributed on the
        host so that every column stays nonnegative."""
        p = self.params
        n = p.num_limbs
        K = 2
        d = _limbs_of(K * p.modulus, n + 1)
        for k in range(n):  # borrow so that d_k >= 2^16 - 1 below the top
            if d[k] < LIMB - 1:
                d[k] += LIMB
                d[k + 1] -= 1
        if any(x < 0 for x in d):
            raise ArithmeticError("2·m has no nonnegative digit redistribution")
        total = self.get_raw_value(cs) + K * p.modulus - other.get_raw_value(cs)
        q, r = divmod(total, p.modulus)
        r_limbs, q_limbs = self._alloc_result(cs, r, 2, q)
        columns = []
        for k in range(n + 1):
            terms = ([(self.limbs[k], 1), (other.limbs[k], cs.p - 1)] if k < n else [])
            columns.append((terms, d[k]))
        _enforce_congruence(cs, columns, q_limbs, r_limbs, p)
        return NonNativeField(r_limbs, p)

    def negated(self, cs) -> "NonNativeField":
        return NonNativeField.zero(cs, self.params).sub(cs, self)

    def mul(self, cs, other: "NonNativeField") -> "NonNativeField":
        p = self.params
        q, r = divmod(self.get_raw_value(cs) * other.get_raw_value(cs), p.modulus)
        r_limbs, q_limbs = self._alloc_result(cs, r, p.num_limbs + 1, q)
        columns = _product_columns(cs, self.limbs, other.limbs)
        _enforce_congruence(cs, columns, q_limbs, r_limbs, p)
        return NonNativeField(r_limbs, p)

    def square(self, cs) -> "NonNativeField":
        return self.mul(cs, self)

    def inv(self, cs) -> "NonNativeField":
        """The inverse as a witness with self·inv ≡ 1 (mod m) enforced; self
        must be nonzero mod m."""
        p = self.params
        n = p.num_limbs
        raw = self.get_raw_value(cs)
        iv = pow(raw % p.modulus, -1, p.modulus)
        iv_limbs = _checked_limbs(cs, _limbs_of(iv, n))
        q_limbs = _checked_limbs(cs, _limbs_of((raw * iv - 1) // p.modulus, n + 1))
        one_limbs = [cs.one_var()] + [cs.zero_var()] * (n - 1)
        columns = _product_columns(cs, self.limbs, iv_limbs)
        _enforce_congruence(cs, columns, q_limbs, one_limbs, p)
        return NonNativeField(iv_limbs, p)

    def div(self, cs, other: "NonNativeField") -> "NonNativeField":
        return self.mul(cs, other.inv(cs))

    def enforce_reduced(self, cs):
        """Enforce raw value < m: (m - 1) - self has no borrow, a 16-bit
        add chain self + d = m - 1 whose last carry is pinned to zero."""
        p = self.params
        n = p.num_limbs
        m1 = _limbs_of(p.modulus - 1, n)
        raw = self.get_raw_value(cs)
        if raw >= p.modulus:
            raise ArithmeticError("witness not reduced")
        d = p.modulus - 1 - raw
        gate = UIntXAddGate(16)
        carry = cs.zero_var()
        for k in range(n):
            dv = cs.alloc_variable_with_value((d >> (16 * k)) & (LIMB - 1))
            decompose_and_check(cs, dv, LIMB_BITS)
            if k + 1 < n:
                low = (1 << (16 * (k + 1))) - 1
                cout = cs.alloc_variable_with_value(
                    1 if (raw & low) + (d & low) >= 1 << (16 * (k + 1)) else 0)
            else:
                cout = cs.zero_var()
            m1_var = cs.allocate_constant(m1[k])
            cs.place_gate(gate, [self.limbs[k], dv, carry, m1_var, cout], ())
            carry = cout

    @staticmethod
    def equals(cs, a: "NonNativeField", b: "NonNativeField") -> Boolean:
        """Canonical equality: both sides reduced, then limb by limb."""
        a.enforce_reduced(cs)
        b.enforce_reduced(cs)
        return Boolean.multi_and(cs, [Num(la).equals(cs, Num(lb))
                                      for la, lb in zip(a.limbs, b.limbs)])

    def is_zero(self, cs) -> Boolean:
        self.enforce_reduced(cs)
        total = Num.linear_combination(cs, [Num(v) for v in self.limbs],
                                       [1] * self.params.num_limbs)
        return total.is_zero(cs)

    @staticmethod
    def select(cs, flag: Boolean, a: "NonNativeField", b: "NonNativeField"):
        if a.params is not b.params:
            raise TypeError("select over two fields")
        return NonNativeField([SelectionGate.select(cs, flag.var, la, lb)
                               for la, lb in zip(a.limbs, b.limbs)], a.params)


# the parameter sets era-boojum's precompiles use (secp256k1 for ecrecover)
SECP256K1_BASE = NNFParams((1 << 256) - (1 << 32) - 977, "secp256k1_base")
SECP256K1_SCALAR = NNFParams(
    0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141, "secp256k1_scalar")
BN254_BASE = NNFParams(
    21888242871839275222246405745257275088696311157297823662689037894645226208583,
    "bn254_base")
