"""boojum_tpu_torch's wide integers, non-native fields, curves, derived
gadgets and field-like circuit ops against boojum_tpu's (CPU), and the
secp256k1 ladder proved by both packages.

- Every test of the JAX package's tests/test_wide_int.py,
  tests/test_nnf_curves.py and tests/test_aux.py::test_derive_gadget runs
  once over each package's classes (one circuit definition, two
  namespaces), with its inputs (seeded `random`) and sizes: the values
  equal each other and the host's integer arithmetic, the assemblies are
  word for word the same (tolerance 0: exact field elements), and both
  satisfiability checks agree, the congruence tamper included.
- CircuitOps and CircuitExtOps over the same ops: the same values and
  assembly.
- Over BabyBear, the non-native field and the circuit ops are refused; the
  two parametrised gates take BabyBear constants as the JAX gates do; the
  port's Boolean gives the right words where the JAX package's does not.
- The secp256k1 ladder (circuits.secp256k1_ladder) at 2^12 rows, two steps,
  from one seed: the same assembly, the result equal to [k]G on the host;
  set up and proved by each package (LDE 2), the same checkpoint stream and
  proof JSON, and each verifier accepts the other's proof.
"""

import copy
import dataclasses
import random
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import pytest

from boojum_tpu.cs.implementations import ConstraintSystem as JConstraintSystem
from boojum_tpu.cs.types import CSGeometry as JCSGeometry
from boojum_tpu.cs.types import LookupParameters as JLookupParameters
from boojum_tpu.gadgets import boolean as jboolean
from boojum_tpu.gadgets import curves as jcurves
from boojum_tpu.gadgets import derive as jderive
from boojum_tpu.gadgets import field_like_circuit as jflc
from boojum_tpu.gadgets import non_native_field as jnnf
from boojum_tpu.gadgets import num as jnum
from boojum_tpu.gadgets import uint as juint
from boojum_tpu.gadgets import wide_int as jwide
from boojum_tpu.prover.satisfiability import check_if_satisfied as jcheck
from boojum_tpu_torch import gadgets as tgadgets
from boojum_tpu_torch.circuits import (
    LADDER_FIXED_ROWS, LADDER_ROWS_PER_STEP, SECP256K1_G, build_secp256k1_ladder,
    secp256k1_ladder, secp256k1_ladder_proof_config, secp256k1_ladder_steps,
    secp256k1_mul_host,
)
from boojum_tpu_torch.cs.implementations import ConstraintSystem, FieldCapacityError
from boojum_tpu_torch.cs.types import CSGeometry, LookupParameters
from boojum_tpu_torch.prover.satisfiability import check_if_satisfied
from test_nnf_curves import _ec_add
from torch_port_util import assert_same_assembly

P = 0xFFFFFFFF00000001
BB_P = 2013265921
SECP_P = jnnf.SECP256K1_BASE.modulus
GEOM = (60, 0, 8, 7)  # the JAX tests' geometry and lookups: sha256's
LOOKUP = (4, 8)


def _namespace(ConstraintSystem, CSGeometry, LookupParameters, check, m):
    return SimpleNamespace(
        ConstraintSystem=ConstraintSystem, CSGeometry=CSGeometry,
        LookupParameters=LookupParameters, check=check, **{
            k: getattr(m, k) for k in (
                "Boolean", "Num", "UInt8", "UInt160", "UInt256", "UInt512", "NonNativeField",
                "SECP256K1_BASE", "SWProjectivePoint", "CircuitOps", "CircuitExtOps",
                "derive_gadget")})


JNS = _namespace(JConstraintSystem, JCSGeometry, JLookupParameters, jcheck, SimpleNamespace(
    Boolean=jboolean.Boolean, Num=jnum.Num, UInt8=juint.UInt8, UInt160=jwide.UInt160,
    UInt256=jwide.UInt256, UInt512=jwide.UInt512, NonNativeField=jnnf.NonNativeField,
    SECP256K1_BASE=jnnf.SECP256K1_BASE, SWProjectivePoint=jcurves.SWProjectivePoint,
    CircuitOps=jflc.CircuitOps, CircuitExtOps=jflc.CircuitExtOps,
    derive_gadget=jderive.derive_gadget))
TNS = _namespace(ConstraintSystem, CSGeometry, LookupParameters, check_if_satisfied, tgadgets)


def make_cs(m, size):
    return m.ConstraintSystem(m.CSGeometry(*GEOM), size,
                              lookup_params=m.LookupParameters(*LOOKUP))


# ---- the JAX tests' circuits, over the classes of namespace m --------------
# Each returns (cs, the values it read); it asserts what the JAX test does.

def u256_add_sub(m):
    rng, cs, M = random.Random(3), make_cs(m, 1 << 14), 1 << 256
    out = []
    for _ in range(3):
        a, b = rng.randrange(M), rng.randrange(M)
        ua, ub = m.UInt256.allocate_checked(cs, a), m.UInt256.allocate_checked(cs, b)
        s, c = ua.overflowing_add(cs, ub)
        d, brw = ua.overflowing_sub(cs, ub)
        out += [s.get_value(cs), c.get_value(cs), d.get_value(cs), brw.get_value(cs)]
        assert out[-4:] == [(a + b) % M, a + b >= M, (a - b) % M, a < b]
    return cs, out


def u256_widening_mul(m):
    rng, cs, M = random.Random(5), make_cs(m, 1 << 14), 1 << 256
    a, b = rng.randrange(M), rng.randrange(M)
    p = m.UInt256.allocate_checked(cs, a).widening_mul(cs, m.UInt256.allocate_checked(cs, b))
    out = [p.get_value(cs), p.to_low().get_value(cs), p.to_high().get_value(cs)]
    assert out == [a * b, (a * b) % M, (a * b) >> 256]
    return cs, out


def u256_predicates_and_bytes(m):
    rng, cs = random.Random(9), make_cs(m, 1 << 14)
    a = rng.randrange(1 << 256)
    ua, ub = m.UInt256.allocate_checked(cs, a), m.UInt256.allocate_checked(cs, a)
    uc = m.UInt256.allocate_checked(cs, (a + 1) % (1 << 256))
    out = [m.UInt256.equals(cs, ua, ub).get_value(cs), m.UInt256.equals(cs, ua, uc).get_value(cs),
           m.UInt256.zero(cs).is_zero(cs).get_value(cs), ua.is_zero(cs).get_value(cs)]
    le = ua.to_le_bytes(cs)
    out += [m.UInt256.from_le_bytes(cs, le).get_value(cs), bytes(v.get_value(cs) for v in le)]
    half, odd = ua.div2(cs)
    out += [half.get_value(cs), odd.get_value(cs)]
    t, f = m.Boolean.allocate(cs, True), m.Boolean.allocate(cs, False)
    out += [ua.mask(cs, f).get_value(cs), ua.mask(cs, t).get_value(cs),
            m.UInt256.select(cs, t, ua, uc).get_value(cs)]
    assert out == [True, False, True, a == 0, a, a.to_bytes(32, "little"), a >> 1,
                   bool(a & 1), 0, a, a]
    return cs, out


def u160_u512_basic(m):
    rng, cs = random.Random(13), make_cs(m, 1 << 14)
    a = rng.randrange(1 << 160)
    ua = m.UInt160.allocate_checked(cs, a)
    b = rng.randrange(1 << 512)
    s, _c = m.UInt512.allocate_checked(cs, b).overflowing_add(
        cs, m.UInt512.allocated_constant(cs, b))
    out = [ua.get_value(cs), s.get_value(cs)]
    assert out == [a, (2 * b) % (1 << 512)]
    return cs, out


def nnf_ring_ops(m):
    rng, cs, F = random.Random(17), make_cs(m, 1 << 15), m.SECP256K1_BASE
    a, b = rng.randrange(SECP_P), rng.randrange(SECP_P)
    na = m.NonNativeField.allocate_checked(cs, a, F)
    nb = m.NonNativeField.allocate_checked(cs, b, F)
    out = [x.get_value(cs) for x in (
        na.add(cs, nb), na.sub(cs, nb), nb.sub(cs, na), na.mul(cs, nb), na.square(cs),
        na.negated(cs), na.inv(cs), na.div(cs, nb))]
    assert out == [(a + b) % SECP_P, (a - b) % SECP_P, (b - a) % SECP_P, a * b % SECP_P,
                   a * a % SECP_P, -a % SECP_P, pow(a, -1, SECP_P),
                   a * pow(b, -1, SECP_P) % SECP_P]
    return cs, out


def nnf_predicates(m):
    cs, F, a = make_cs(m, 1 << 15), m.SECP256K1_BASE, 12345678901234567890
    na, nb, nc = (m.NonNativeField.allocate_checked(cs, v, F) for v in (a, a, a + 1))
    out = [m.NonNativeField.equals(cs, na, nb).get_value(cs),
           m.NonNativeField.equals(cs, na, nc).get_value(cs),
           m.NonNativeField.zero(cs, F).is_zero(cs).get_value(cs), na.is_zero(cs).get_value(cs)]
    assert out == [True, False, True, False]
    return cs, out


def nnf_congruence(m):
    """3·5, whose first result limb the tamper case changes."""
    cs, F = make_cs(m, 1 << 15), m.SECP256K1_BASE
    prod = m.NonNativeField.allocate_checked(cs, 3, F).mul(
        cs, m.NonNativeField.allocate_checked(cs, 5, F))
    return cs, [prod.get_value(cs), prod.limbs[0]]


def curve_double_add(m):
    cs, F = make_cs(m, 1 << 16), m.SECP256K1_BASE
    gx = m.NonNativeField.allocate_checked(cs, SECP256K1_G[0], F)
    gy = m.NonNativeField.allocate_checked(cs, SECP256K1_G[1], F)
    pt = m.SWProjectivePoint.from_xy_unchecked(cs, gx, gy, 7)
    pt.enforce_on_curve(cs)
    two_g = pt.double(cs)
    three_g = two_g.add_mixed(cs, gx, gy)
    (x2, y2), inf2 = two_g.convert_to_affine_or_default(cs, 0, 0)
    (x3, y3), inf3 = three_g.convert_to_affine_or_default(cs, 0, 0)
    out = [inf2.get_value(cs), inf3.get_value(cs), (x2.get_value(cs), y2.get_value(cs)),
           (x3.get_value(cs), y3.get_value(cs))]
    e2 = _ec_add(SECP256K1_G, SECP256K1_G)
    assert out == [False, False, e2, _ec_add(e2, SECP256K1_G)]
    return cs, out


def curve_identity(m):
    cs, F = make_cs(m, 1 << 16), m.SECP256K1_BASE
    zero_pt = m.SWProjectivePoint.zero(cs, F, 7)
    gx = m.NonNativeField.allocate_checked(cs, SECP256K1_G[0], F)
    gy = m.NonNativeField.allocate_checked(cs, SECP256K1_G[1], F)
    (x, y), inf = zero_pt.add_mixed(cs, gx, gy).convert_to_affine_or_default(cs, 0, 0)
    diff = m.SWProjectivePoint.from_xy_unchecked(cs, gx, gy, 7).sub_mixed(cs, gx, gy)
    _, inf_d = diff.convert_to_affine_or_default(cs, 0, 0)
    out = [inf.get_value(cs), (x.get_value(cs), y.get_value(cs)), inf_d.get_value(cs)]
    assert out == [False, SECP256K1_G, True]
    return cs, out


def derive_gadget(m):
    @m.derive_gadget
    @dataclass
    class Point:
        x: m.Num
        y: m.Num

    @m.derive_gadget
    @dataclass
    class Flagged:
        p: Point
        ok: m.Boolean

    cs = m.ConstraintSystem(m.CSGeometry(16, 0, 6, 4), 256)
    a = Flagged.allocate(cs, {"p": {"x": 3, "y": 4}, "ok": True})
    b = Flagged.allocate(cs, {"p": {"x": 30, "y": 40}, "ok": False})
    out = [Flagged.witness_hook(cs, Flagged.select(cs, m.Boolean.allocate(cs, flag), a, b))()
           for flag in (True, False)]
    assert out == [{"p": {"x": 3, "y": 4}, "ok": True}, {"p": {"x": 30, "y": 40}, "ok": False}]
    return cs, out


def field_like_ops(m):
    """Every op of CircuitOps and CircuitExtOps on seeded values."""
    cs = m.ConstraintSystem(m.CSGeometry(16, 0, 6, 4), 1 << 10)
    rng = random.Random(23)
    base, ext = m.CircuitOps(cs), m.CircuitExtOps(cs)
    a, b, c = (cs.alloc_variable_with_value(rng.randrange(P)) for _ in range(3))
    flag = m.Boolean.allocate(cs, True).var
    vals = [base.add(a, b), base.sub(a, b), base.mul(a, b), base.neg(a), base.double(b),
            base.fma(a, b, c, 5, 7), base.mul_by_constant(c, 11), base.inv(a),
            base.select(flag, a, b), base.constant(P + 3)]
    base.enforce_equal(vals[0], base.add(b, a))
    base.enforce_zero(base.sub(c, c))
    x, y = (a, b), (c, ext.constant(9)[0])
    pairs = [ext.add(x, y), ext.sub(x, y), ext.neg(x), ext.double(y), ext.mul(x, y),
             ext.mul_by_base(x, c), ext.mul_by_base_constant(y, 13), ext.inv(x),
             ext.pow(x, 5), ext.pow(y, 0), ext.select(flag, x, y), ext.from_base_var(a),
             ext.from_base_constants(2, 3), ext.one(), ext.zero()]
    ext.enforce_equal(ext.mul(x, pairs[7]), ext.one())
    out = [cs.get_value(v) for v in vals] + [ext.get_value(p) for p in pairs]
    return cs, out


CIRCUITS = {f.__name__: f for f in (
    u256_add_sub, u256_widening_mul, u256_predicates_and_bytes, u160_u512_basic,
    nnf_ring_ops, nnf_predicates, nnf_congruence, curve_double_add, curve_identity,
    derive_gadget, field_like_ops)}


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_circuit_matches_jax(name):
    """Values, assembly and satisfiability of one circuit, both packages."""
    (jcs, jvals), (tcs, tvals) = (CIRCUITS[name](m) for m in (JNS, TNS))
    assert tvals == jvals
    ja, ta = jcs.into_assembly(), tcs.into_assembly()
    assert_same_assembly(ta, ja)
    assert check_if_satisfied(ta) and jcheck(ja)


def test_congruence_tamper_rejected_by_both():
    """The JAX test's tamper: the first result limb of 3·5, changed by 1 in
    its first copy cell, fails both checks."""
    bad = []
    for m in (JNS, TNS):
        cs, (_value, place) = nnf_congruence(m)
        asm = copy.copy(cs.into_assembly())
        col, row = np.argwhere(asm.copy_placement == place)[0]
        asm.copy_cols_values = asm.copy_cols_values.copy()
        asm.copy_cols_values[col, row] = (int(asm.copy_cols_values[col, row]) + 1) % P
        bad.append(asm)
    assert not jcheck(bad[0]) and not check_if_satisfied(bad[1])


def _bb_cs():
    return ConstraintSystem(CSGeometry(*GEOM), 1 << 12, lookup_params=LookupParameters(*LOOKUP),
                            field="babybear")


def test_babybear_refuses_non_native_arithmetic():
    """The limb columns' carry bounds need 64-bit field elements."""
    for build in (lambda cs: tgadgets.NonNativeField.allocate_checked(
                      cs, 5, tgadgets.SECP256K1_BASE),
                  lambda cs: tgadgets.NonNativeField.zero(cs, tgadgets.SECP256K1_BASE),
                  tgadgets.CircuitOps, tgadgets.CircuitExtOps):
        with pytest.raises(FieldCapacityError, match="64-bit field elements"):
            build(_bb_cs())


def test_babybear_parametrised_gates_match_jax(monkeypatch):
    """Over BabyBear both parametrised gates reduce their parameters modulo
    BabyBear's prime, as the JAX gates do under BOOJUM_TPU_FIELD=babybear,
    and compat.port_gate carries the JAX gates over."""
    from boojum_tpu.cs.gates import simple as jsimple
    from boojum_tpu_torch.compat import port_gate
    from boojum_tpu_torch.cs.gates import simple as tsimple

    monkeypatch.setenv("BOOJUM_TPU_FIELD", "babybear")
    jconst = jsimple.ExplicitConstantsAllocatorGate((5,))
    jmat = jsimple.MatrixMultiplicationGate("m", [[1, -1], [2, 3]])
    jcs = JConstraintSystem(JCSGeometry(8, 0, 6, 4), 64)
    jx, jy = jcs.alloc_variable_with_value(3), jcs.alloc_variable_with_value(4)
    jouts = [jcs.get_value(v) for v in jmat.apply(jcs, [jx, jy])]
    jalloc = jsimple.ExplicitConstantsAllocatorGate.allocate(jcs, (5,))
    monkeypatch.delenv("BOOJUM_TPU_FIELD")
    tconst = tsimple.ExplicitConstantsAllocatorGate((5,), "babybear")
    tmat = tsimple.MatrixMultiplicationGate("m", [[1, -1], [2, 3]], "babybear")
    assert jconst.constants == tconst.constants == [0, 1, BB_P - 1, 5]
    assert tmat.matrix == jmat.matrix == [[1, BB_P - 1], [2, 3]]
    tcs = ConstraintSystem(CSGeometry(8, 0, 6, 4), 64, field="babybear")
    tx, ty = tcs.alloc_variable_with_value(3), tcs.alloc_variable_with_value(4)
    touts = [tcs.get_value(v) for v in tmat.apply(tcs, [tx, ty])]
    assert touts == jouts == [BB_P - 1, 18]
    talloc = tsimple.ExplicitConstantsAllocatorGate.allocate(tcs, (5,))
    assert sorted(talloc) == sorted(jalloc) == [0, 1, 5, BB_P - 1]
    assert [tcs.get_value(talloc[k]) for k in sorted(talloc)] == sorted(talloc)
    for jg, tg in ((jconst, tconst), (jmat, tmat)):
        ported = port_gate(jg)
        assert (ported.name, getattr(ported, "constants", None), getattr(ported, "matrix", None)
                ) == (tg.name, getattr(tg, "constants", None), getattr(tg, "matrix", None))


def test_babybear_boolean_words():
    """The port's Boolean over BabyBear: negate(1) = 0, or(1, 1) = 1 and
    xor(1, 1) = 0, and the circuit is satisfied. The JAX package's Boolean
    (gadgets/boolean.py) passes Goldilocks's p - 1 and p - 2 as coefficients
    whatever the field, and gives 903732710, 903732711 and 903732710 here:
    a BabyBear circuit that places these gadgets cannot be byte-identical
    to the reference's, and no BabyBear parity claim covers one."""
    cs = ConstraintSystem(CSGeometry(8, 0, 6, 4), 64, field="babybear")
    one = tgadgets.Boolean.allocate(cs, True)
    outs = [one.negate(cs), one.or_(cs, one), one.xor(cs, one)]
    assert [cs.get_value(b.var) for b in outs] == [0, 1, 0]
    assert check_if_satisfied(cs.into_assembly())


# ---- the secp256k1 ladder ------------------------------------------------

LADDER_NS = {"jax": SimpleNamespace(
    ConstraintSystem=JConstraintSystem, CSGeometry=JCSGeometry,
    LookupParameters=JLookupParameters, Boolean=jboolean.Boolean,
    NonNativeField=jnnf.NonNativeField, SWProjectivePoint=jcurves.SWProjectivePoint,
    SECP256K1_BASE=jnnf.SECP256K1_BASE)}
CONFIG = dataclasses.asdict(secp256k1_ladder_proof_config())


def _host_mul(k):
    """[k]G through the JAX test's own affine addition."""
    out = None
    for i in reversed(range(k.bit_length())):
        out = _ec_add(out, out)
        if (k >> i) & 1:
            out = _ec_add(out, SECP256K1_G)
    return out


@pytest.fixture(scope="module")
def jax_ladder():
    from boojum_tpu.prover import ProofConfig as JProofConfig
    from boojum_tpu.prover import generate_setup as jgenerate_setup
    from boojum_tpu.prover import prove as jprove
    from boojum_tpu.utils.report import CheckpointLog as JCheckpointLog
    from boojum_tpu.utils.report import install_checkpoint_log

    cs, out = secp256k1_ladder(LADDER_NS["jax"])
    asm = cs.into_assembly()
    cfg = JProofConfig(**CONFIG)
    setup = jgenerate_setup(asm, cfg)
    log = JCheckpointLog()
    prev = install_checkpoint_log(log)
    try:
        proof = jprove(asm, setup, cfg)
    finally:
        install_checkpoint_log(prev)
    return SimpleNamespace(asm=asm, setup=setup, proof=proof, cs=cs, out=out,
                           stream=[(e["round"], e["label"], e["digest"]) for e in log.entries])


@pytest.fixture(scope="module")
def port_ladder():
    from boojum_tpu_torch.prover import ProofConfig, generate_setup, prove
    from boojum_tpu_torch.utils.report import CheckpointLog

    cs, out = build_secp256k1_ladder()
    asm = cs.into_assembly()
    cfg = ProofConfig(**CONFIG)
    setup = generate_setup(asm, cfg, device="cpu")
    log = CheckpointLog()
    proof = prove(asm, setup, cfg, device="cpu", log=log)
    return SimpleNamespace(asm=asm, setup=setup, proof=proof, cs=cs, out=out, stream=log.stream())


def test_ladder_result_is_host_scalar_multiple(jax_ladder, port_ladder):
    for lad in (jax_ladder, port_ladder):
        k = lad.out.scalar
        assert k.bit_length() == 2
        got = (lad.out.x.get_value(lad.cs), lad.out.y.get_value(lad.cs))
        assert not lad.out.at_infinity.get_value(lad.cs)
        assert got == _host_mul(k) == secp256k1_mul_host(k)


def test_ladder_assembly_matches_jax(jax_ladder, port_ladder):
    assert port_ladder.asm.trace_len == 1 << 12
    assert_same_assembly(port_ladder.asm, jax_ladder.asm)
    assert check_if_satisfied(port_ladder.asm) and jcheck(jax_ladder.asm)
    assert port_ladder.setup.vk.setup_merkle_cap == jax_ladder.setup.vk.setup_merkle_cap


def test_ladder_checkpoint_stream_and_proof_match_jax(jax_ladder, port_ladder):
    assert port_ladder.stream == jax_ladder.stream
    assert port_ladder.proof.to_json() == jax_ladder.proof.to_json()


def test_ladder_verifiers_accept_each_others_proofs(jax_ladder, port_ladder):
    from boojum_tpu.prover import verify as jverify
    from boojum_tpu.prover.proof import Proof as JProof
    from boojum_tpu_torch.prover import verify
    from boojum_tpu_torch.prover.proof import Proof

    assert verify(port_ladder.setup.vk, Proof.from_json(jax_ladder.proof.to_json()),
                  port_ladder.asm.gates)
    assert jverify(jax_ladder.setup.vk, JProof.from_json(port_ladder.proof.to_json()),
                   jax_ladder.asm.gates)


@pytest.mark.parametrize("steps", [1, 3])
def test_ladder_rows_rule_leaves_rows_to_spare(steps, monkeypatch):
    """A ladder of `steps` steps takes no more gate rows than the rule that
    sizes it to 2^log_n rows counts (and more than its lookups take), and the
    rule fills 2^18 and 2^20 with at most that many."""
    from boojum_tpu_torch import circuits

    monkeypatch.setattr(circuits, "secp256k1_ladder_steps", lambda _log_n: steps)
    cs, out = circuits.build_secp256k1_ladder(log_n=16)
    assert cs.next_row <= LADDER_FIXED_ROWS + steps * LADDER_ROWS_PER_STEP
    assert cs.next_row > steps * (LADDER_ROWS_PER_STEP - 10)
    lookups = {}
    for tid, _places in cs.lookup_rows:
        lookups[tid] = lookups.get(tid, 0) + 1
    assert sum(-(-c // 8) for c in lookups.values()) < cs.next_row
    assert (out.x.get_value(cs), out.y.get_value(cs)) == secp256k1_mul_host(out.scalar)
    for log_n in (18, 20):
        assert (LADDER_FIXED_ROWS + secp256k1_ladder_steps(log_n) * LADDER_ROWS_PER_STEP
                <= 1 << log_n)
