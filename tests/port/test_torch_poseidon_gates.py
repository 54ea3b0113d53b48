"""boojum_tpu_torch's flattened Poseidon2 and Poseidon gates, the extension
FMA gate, the circuit sponges, the queues and the toy round-function
circuit against boojum_tpu's (CPU), and the quotient sweep's (B6)
encoding with each term folded as it is made.

- Each flat gate's witness trace equals the JAX `_witness_trace` and the
  host permutation; each gate's shape and captured program equal the JAX
  gate's; the program, encoded for B6 and run through its plain
  interpreter on random rows (boundary words in the first), gives the
  α-weighted sum of the terms the JAX gate's `evaluate` gives over host
  ints (tolerance 0: exact field elements).
- The circuit sponges (leaf hashes of 3, 8, 11, 16 and 20 elements, an
  incremental absorb, a node hash, the legacy sponge), the Poseidon2 and
  legacy flat chains of tests/test_poseidon2_gate.py, and the queue and
  sponge-optimizer circuits of tests/test_queue.py and
  tests/test_queue_optimizer.py run once over each package's classes (one
  circuit function, two namespaces): the same values, the same assembly
  word for word, and both satisfiability checks agree, tampering included.
- Over BabyBear the flat gates are refused; the toy round-function circuit
  (circuits.build_poseidon_rf) equals the JAX assembly over both fields.
- B6's encoding: every gate of the gate zoo and the three new gates encode
  within their old slot counts (or the MAX_SLOTS limit) and the plain
  interpreter gives the same terms as the captured program run directly;
  the legacy gate's 4,680 constants are stored as 368.
"""

import random
from types import SimpleNamespace

import numpy as np
import pytest

from boojum_tpu.cs import field_like as jfl
from boojum_tpu.cs.gate_capture import capture_gate_program as jcapture
from boojum_tpu.cs.gates import base as jbase
from boojum_tpu.cs.gates import ext_fma as jext_fma
from boojum_tpu.cs.gates import poseidon2_flat as jp2flat
from boojum_tpu.cs.gates import poseidon_flat as jpflat
from boojum_tpu.cs.gates.simple import PublicInputGate as JPublicInputGate
from boojum_tpu.cs.implementations import ConstraintSystem as JConstraintSystem
from boojum_tpu.cs.types import CSGeometry as JCSGeometry
from boojum_tpu.cs.types import LookupParameters as JLookupParameters
from boojum_tpu.gadgets import poseidon2_rf as jp2rf
from boojum_tpu.gadgets import poseidon_rf as jprf
from boojum_tpu.gadgets import queue as jqueue
from boojum_tpu.gadgets import queue_optimizer as jqopt
from boojum_tpu.gadgets.boolean import Boolean as JBoolean
from boojum_tpu.hashes.poseidon import PoseidonSpongeHost as JPoseidonSpongeHost
from boojum_tpu.hashes.poseidon2 import Poseidon2SpongeHost as JPoseidon2SpongeHost
from boojum_tpu.prover.satisfiability import check_if_satisfied as jcheck
from boojum_tpu_torch import circuits
from boojum_tpu_torch.cs import field_like as tfl
from boojum_tpu_torch.cs.gate_capture import capture_gate_program
from boojum_tpu_torch.cs.gates import (
    ExtFmaGate, Poseidon2FlattenedGate, PoseidonFlattenedGate, PublicInputGate,
)
from boojum_tpu_torch.cs.gates import poseidon2_flat as tp2flat
from boojum_tpu_torch.cs.gates import poseidon_flat as tpflat
from boojum_tpu_torch.cs.implementations import ConstraintSystem, FieldCapacityError
from boojum_tpu_torch.cs.types import CSGeometry, LookupParameters
from boojum_tpu_torch.gadgets import poseidon2_rf as tp2rf
from boojum_tpu_torch.gadgets import poseidon_rf as tprf
from boojum_tpu_torch.gadgets import queue as tqueue
from boojum_tpu_torch.gadgets import queue_optimizer as tqopt
from boojum_tpu_torch.gadgets.boolean import Boolean
from boojum_tpu_torch.hashes.poseidon import PoseidonSpongeHost, poseidon_permutation_host
from boojum_tpu_torch.hashes.poseidon2 import Poseidon2SpongeHost, poseidon2_permutation_host
from boojum_tpu_torch.prover import quotient_sweep as qs
from boojum_tpu_torch.prover.satisfiability import check_if_satisfied
from torch_port_util import BOUNDARY, assert_same_assembly, rand_words, to_np, to_t

P = 0xFFFFFFFF00000001
GEOM = (130, 0, 8, 7)  # the recursion geometry of the JAX tests
FLAT = {"poseidon2_flat": (Poseidon2FlattenedGate, jp2flat.Poseidon2FlattenedGate,
                           tp2flat, jp2flat, poseidon2_permutation_host),
        "poseidon_flat": (PoseidonFlattenedGate, jpflat.PoseidonFlattenedGate, tpflat, jpflat,
                          poseidon_permutation_host)}
NEW_GATES = {"poseidon2_flat": (Poseidon2FlattenedGate, jp2flat.Poseidon2FlattenedGate),
             "poseidon_flat": (PoseidonFlattenedGate, jpflat.PoseidonFlattenedGate),
             "ext_fma": (ExtFmaGate, jext_fma.ExtFmaGate)}


def _namespace(ConstraintSystem, CSGeometry, LookupParameters, check, Boolean, p2rf, prf,
               queue, qopt, PublicInputGate, P2Host, PHost):
    return SimpleNamespace(
        ConstraintSystem=ConstraintSystem, CSGeometry=CSGeometry,
        LookupParameters=LookupParameters, check=check, Boolean=Boolean,
        perm2=p2rf.circuit_permutation, perm=prf.circuit_permutation,
        hash_leaf=p2rf.circuit_hash_leaf, hash_node=p2rf.circuit_hash_node,
        Sponge=p2rf.CircuitPoseidon2Sponge, legacy_leaf=prf.circuit_hash_leaf,
        legacy_node=prf.circuit_hash_node, CircuitQueue=queue.CircuitQueue,
        FullStateCircuitQueue=queue.FullStateCircuitQueue,
        SpongeOptimizer=qopt.SpongeOptimizer,
        hash_with_optimizer=qopt.variable_length_hash_with_optimizer,
        PublicInputGate=PublicInputGate, P2Host=P2Host, PHost=PHost)


JNS = _namespace(JConstraintSystem, JCSGeometry, JLookupParameters, jcheck, JBoolean, jp2rf,
                 jprf, jqueue, jqopt, JPublicInputGate, JPoseidon2SpongeHost,
                 JPoseidonSpongeHost)
TNS = _namespace(ConstraintSystem, CSGeometry, LookupParameters, check_if_satisfied, Boolean,
                 tp2rf, tprf, tqueue, tqopt, PublicInputGate, Poseidon2SpongeHost,
                 PoseidonSpongeHost)


def make_cs(m, size=1 << 12, lookups=False):
    lp = m.LookupParameters(width=4, num_repetitions=8) if lookups else None
    return m.ConstraintSystem(m.CSGeometry(*GEOM), size, lookup_params=lp)


def _values(cs, vs):
    return [cs.get_value(v) for v in vs]


# ---- the gates ---------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(FLAT))
def test_flat_witness_trace_matches_jax_and_host(name):
    _g, _jg, tmod, jmod, host = FLAT[name]
    rng = random.Random(len(name))
    for inputs in ([0] * 12, [P - 1] * 12, [rng.randrange(P) for _ in range(12)]):
        out, aux = tmod._witness_trace(inputs)
        assert (out, aux) == tuple(map(list, jmod._witness_trace(inputs)))
        assert out == host(inputs)
        assert len(aux) == tmod.NUM_AUX == 106


@pytest.mark.parametrize("name", sorted(NEW_GATES))
def test_gate_shape_and_captured_program_match_jax(name):
    gate, jgate = (g.instance() for g in NEW_GATES[name])
    for attr in ("name", "principal_width", "witness_width", "num_constants", "num_terms",
                 "max_degree"):
        assert getattr(gate, attr) == getattr(jgate, attr), attr
    got, want = capture_gate_program(gate), jcapture(jgate)
    fields = ("loads", "consts", "ops", "terms", "num_slots")
    assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}


@pytest.mark.parametrize("name", sorted(NEW_GATES))
def test_encoded_program_matches_jax_evaluate(name):
    """The encoded program through the plain B6 interpreter (the gate alone,
    no selector) against Σ_t α_t·term_t of the JAX gate's evaluate over host
    ints, row by row; random α powers weigh every term at once."""
    gate, jgate = (g.instance() for g in NEW_GATES[name])
    geometry = CSGeometry(*GEOM)
    rng = np.random.default_rng(len(name))
    n = 4
    reps = gate.num_repetitions(geometry)
    copy = rand_words(rng, 130, n)
    copy[:, 0] = BOUNDARY[np.arange(130) % len(BOUNDARY)]
    consts = rand_words(rng, 8, n)
    pows = [tuple(int(v) for v in rand_words(rng, 2)) for _ in range(reps * gate.num_terms)]
    fn = qs.gate_terms_fn([gate], [[]], geometry, "cpu")
    t0, t1 = (to_np(t) for t in fn(to_t(copy), None, to_t(consts), pows))
    for r in range(n):
        want0 = want1 = 0
        t = 0
        for inst in range(reps):
            col = inst * gate.principal_width
            dst = jbase.TermsCollector()
            jgate.evaluate(jfl.ScalarOps, jbase.RowView(
                lambda i, r=r, col=col: int(copy[col + i, r]), None,
                lambda i, r=r: int(consts[i, r])), dst)
            for term in dst.terms:
                want0 = (want0 + int(term) * pows[t][0]) % P
                want1 = (want1 + int(term) * pows[t][1]) % P
                t += 1
        assert (int(t0[r]), int(t1[r])) == (want0, want1), r


def test_flat_gates_refuse_babybear():
    cs = ConstraintSystem(CSGeometry(*GEOM), 1 << 8, field="babybear")
    ins = [cs.alloc_variable_with_value(i) for i in range(12)]
    for perm in (tp2rf.circuit_permutation, tprf.circuit_permutation):
        with pytest.raises(FieldCapacityError):
            perm(cs, ins)


def test_ext_fma_and_inversion_match_jax():
    def circuit(m, ExtFma):
        cs = make_cs(m, 1 << 8)
        a, b, c = ([cs.alloc_variable_with_value(v) for v in pair]
                   for pair in ((3, 5), (P - 2, 7), (11, 2**40)))
        d = ExtFma.fma(cs, a, b, c, (2, 9), (P - 1, 4))
        inv = ExtFma.inversion(cs, d)
        m.PublicInputGate.place(cs, inv[1])
        return cs, _values(cs, [*d, *inv])

    (tcs, tv), (jcs, jv) = circuit(TNS, ExtFmaGate), circuit(JNS, jext_fma.ExtFmaGate)
    assert tv == jv
    ta, ja = tcs.into_assembly(), jcs.into_assembly()
    assert_same_assembly(ta, ja)
    assert check_if_satisfied(ta) and jcheck(ja)


# ---- sponges, chains and queues, one circuit over two namespaces ---------------


def sponges(m):
    rng = random.Random(11)
    cs, out = make_cs(m), []
    for length in (3, 8, 11, 16, 20):
        values = [rng.randrange(P) for _ in range(length)]
        digest = _values(cs, m.hash_leaf(cs, [cs.alloc_variable_with_value(v)
                                              for v in values]))
        assert digest == list(m.P2Host.hash_leaf(values))
        out.append(digest)
    sp = m.Sponge(cs)
    values = [rng.randrange(P) for _ in range(13)]
    for part in (values[:5], values[5:9], values[9:]):  # absorbed in three calls
        sp.absorb([cs.alloc_variable_with_value(v) for v in part])
    out.append(_values(cs, sp.finalize()))
    assert out[-1] == list(m.P2Host.hash_leaf(values))
    left, right = out[0], out[1]
    node = _values(cs, m.hash_node(cs, [cs.alloc_variable_with_value(v) for v in left],
                                   [cs.alloc_variable_with_value(v) for v in right]))
    assert node == list(m.P2Host.hash_node(left, right))
    vals = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]  # one full and one padded chunk
    legacy = _values(cs, m.legacy_leaf(cs, [cs.alloc_variable_with_value(v) for v in vals]))
    assert legacy == list(m.PHost.hash_leaf(vals))
    legacy_node = _values(cs, m.legacy_node(
        cs, [cs.alloc_variable_with_value(v) for v in legacy],
        [cs.alloc_variable_with_value(7) for _ in range(4)]))
    assert legacy_node == list(m.PHost.hash_node(legacy, [7] * 4))
    return cs, out + [node, legacy, legacy_node]


def chain(m, legacy):
    """tests/test_poseidon2_gate.py's chain: 8 permutations from 0..11, the
    first output lane public, at 2^10 rows."""
    cs = m.ConstraintSystem(m.CSGeometry(*GEOM), 1 << 10)
    state = [cs.alloc_variable_with_value(i) for i in range(12)]
    for _ in range(8):
        state = (m.perm if legacy else m.perm2)(cs, state)
    m.PublicInputGate.place(cs, state[0])
    return cs, _values(cs, state)


def queue_roundtrip(m, full_state, tamper=False):
    cs = make_cs(m, 1 << 14, lookups=True)
    width = 8 if full_state else 3
    q = (m.FullStateCircuitQueue if full_state else m.CircuitQueue)(cs, element_width=width)
    items = [[i * width + j for j in range(width)] for i in range(3)]
    for it in items:
        q.push(cs, [cs.alloc_variable_with_value(v) for v in it])
    if tamper:
        q._witness[1] = [v + 1 for v in q._witness[1]]
    popped = []
    while q._witness:
        popped.append(_values(cs, q.pop_front(cs)))
    assert (popped == items) != tamper
    assert q.is_empty(cs).get_value(cs)
    q.enforce_consistency(cs)
    return cs, popped


def optimizer_hash(m):
    cs = make_cs(m)
    inputs = [cs.alloc_variable_with_value(v) for v in (3, 1, 4, 1, 5, 9, 2, 6)]
    execute = m.Boolean.allocated_constant(cs, True)
    opt = m.SpongeOptimizer(cs, capacity=2, num_ids=1)
    got = m.hash_with_optimizer(cs, inputs, 0, execute, opt)
    opt.enforce()
    assert opt.is_fresh()
    want = m.hash_leaf(cs, inputs)
    assert _values(cs, got) == _values(cs, want)
    return cs, _values(cs, got)


def optimizer_queues(m, two_hot=False):
    """Two queues pushed in turn under complementary flags share one
    permutation a slot; two_hot: both flags set, which the optimizer's
    at-most-one-hot check rejects."""
    cs = make_cs(m)
    qa, qb = m.CircuitQueue(cs, element_width=4), m.CircuitQueue(cs, element_width=4)
    steps = 1 if two_hot else 4
    opt = m.SpongeOptimizer(cs, capacity=steps, num_ids=2)
    for i in range(steps):
        if two_hot:
            to_a = to_b = m.Boolean(cs.alloc_variable_with_value(1))
        else:
            to_a = m.Boolean.allocated_constant(cs, i % 2 == 0)
            to_b = to_a.negate(cs)
        el = [cs.alloc_variable_with_value(10 * i + j) for j in range(4)]
        qa.push_with_optimizer(cs, el, to_a, 0, opt)
        qb.push_with_optimizer(cs, el, to_b, 1, opt)
    opt.enforce()
    if two_hot:
        return cs, []
    got = [_values(cs, q.pop_front(cs)) for q in (qa, qa, qb, qb)]
    assert got == [[0, 1, 2, 3], [20, 21, 22, 23], [10, 11, 12, 13], [30, 31, 32, 33]]
    qa.enforce_consistency(cs)
    qb.enforce_consistency(cs)
    return cs, got


def optimizer_conditional_pop(m):
    cs = make_cs(m)
    q = m.CircuitQueue(cs, element_width=2)
    q.push(cs, [cs.alloc_variable_with_value(v) for v in (7, 8)])
    opt = m.SpongeOptimizer(cs, capacity=2, num_ids=1)
    q.pop_with_optimizer(cs, m.Boolean.allocated_constant(cs, False), 0, opt)
    assert cs.get_value(q.length.var) == 1
    got = _values(cs, q.pop_with_optimizer(cs, m.Boolean.allocated_constant(cs, True), 0, opt))
    assert got == [7, 8] and cs.get_value(q.length.var) == 0
    opt.enforce()
    q.enforce_consistency(cs)
    return cs, got


# (circuit, satisfiable)
CIRCUITS = {
    "sponges": (sponges, True),
    "poseidon2 chain": (lambda m: chain(m, False), True),
    "legacy chain": (lambda m: chain(m, True), True),
    "queue": (lambda m: queue_roundtrip(m, False), True),
    "queue tampered": (lambda m: queue_roundtrip(m, False, tamper=True), False),
    "full-state queue": (lambda m: queue_roundtrip(m, True), True),
    "full-state queue tampered": (lambda m: queue_roundtrip(m, True, tamper=True), False),
    "optimizer hash": (optimizer_hash, True),
    "optimizer queues": (optimizer_queues, True),
    "optimizer two-hot flags": (lambda m: optimizer_queues(m, two_hot=True), False),
    "optimizer conditional pop": (optimizer_conditional_pop, True),
}


@pytest.mark.parametrize("case", sorted(CIRCUITS))
def test_circuit_matches_jax(case):
    circuit, satisfiable = CIRCUITS[case]
    (tcs, tv), (jcs, jv) = circuit(TNS), circuit(JNS)
    assert tv == jv
    ta, ja = tcs.into_assembly(), jcs.into_assembly()
    assert_same_assembly(ta, ja)
    assert check_if_satisfied(ta) == jcheck(ja) == satisfiable


@pytest.mark.parametrize("name", sorted(FLAT))
def test_flat_gate_rejects_a_changed_cell(name):
    """An output cell and an aux cell of one permutation row, each changed
    by one: unsatisfiable."""
    cs, _ = chain(TNS, name == "poseidon_flat")
    for col in (12, 40):
        asm = cs.into_assembly()
        row = next(r for r in range(asm.trace_len)
                   if asm.gates[int(asm.row_gate[r])].name == name)
        asm.copy_cols_values[col, row] = (int(asm.copy_cols_values[col, row]) + 1) % P
        assert not check_if_satisfied(asm)


# ---- the toy round function, over both fields --------------------------------


@pytest.mark.parametrize("field", ["goldilocks", "babybear"])
def test_poseidon_rf_assembly_matches_jax(field):
    from boojum_tpu.examples import build_poseidon_rf_circuit

    with pytest.MonkeyPatch.context() as mp:
        if field == "babybear":  # the JAX package reads the field at synthesis
            mp.setenv("BOOJUM_TPU_FIELD", "babybear")
        jcs, jout = build_poseidon_rf_circuit(num_rounds=48)
        ja = jcs.into_assembly()
    tcs, tout = circuits.build_poseidon_rf(field=field)
    ta = tcs.into_assembly()
    assert ta.field == ja.field == field
    assert tcs.get_value(tout) == jcs.get_value(jout)
    assert_same_assembly(ta, ja)
    assert check_if_satisfied(ta)


# ---- B6's encoding -----------------------------------------------------------

# the slots each gate zoo program took while every term waited for the
# program's end (the encoding before terms were folded as they are made)
OLD_SLOTS = {
    "boolean": 2, "constant": 2, "fma": 3, "selection": 3, "zero_check": 4,
    "reduction4": 3, "reduction_by_powers4": 4, "parallel_selection4": 6,
    "conditional_swap": 4, "dot_product4": 3, "quadratic_combination4": 3, "bounded_fma": 3,
    "nonlinearity7": 2, "matmul_zoo3": 6, "explicit_constants[5,4294967296]": 6,
    "u32_add": 4, "u32_sub": 4, "u32_fma": 9, "uint8_add": 4, "uint16_add": 4,
    "u32_tri_add": 3, "byte_tri_add": 3,
}


@pytest.fixture(scope="module")
def zoo():
    asm = circuits.build_gate_zoo(8)[0].into_assembly()
    return [g for g in asm.gates if g.num_terms], asm.geometry


def test_zoo_has_every_gate_with_an_old_slot_count(zoo):
    assert {g.name for g in zoo[0]} == set(OLD_SLOTS)


@pytest.mark.parametrize("name", sorted(OLD_SLOTS))
def test_zoo_programs_encode_within_their_old_slots(zoo, name):
    gates, geometry = zoo
    g = next(g for g in gates if g.name == name)
    _prog, _k, slots, _ops = qs.encode_gate_programs([g], [[]], geometry,
                                                     geometry.num_columns_under_copy_permutation)
    assert slots <= OLD_SLOTS[name]


def test_zoo_encoding_gives_the_captured_programs_terms(zoo):
    """The whole zoo in one table (each gate on its own selector path): the
    plain interpreter against each captured program run directly over word
    tensors, α-weighted and selected as the sweep sums them."""
    from boojum_tpu_torch.cs.gates.base import RowView
    from boojum_tpu_torch.field import extension as ext_f
    from boojum_tpu_torch.field import goldilocks as gf
    from boojum_tpu_torch.prover.setup import build_selector_tree

    gates, geometry = zoo
    _tree, paths = build_selector_tree(gates)
    rng = np.random.default_rng(3)
    n = 8
    Cg, K = geometry.num_columns_under_copy_permutation, geometry.num_constant_columns
    copy, consts = rand_words(rng, Cg, n), rand_words(rng, K, n)
    num = qs.num_gate_terms(gates, geometry)
    pows = [tuple(int(v) for v in rand_words(rng, 2)) for _ in range(num)]
    fn = qs.gate_terms_fn(gates, paths, geometry, "cpu")
    got = [to_np(t) for t in fn(to_t(copy), None, to_t(consts), pows)]
    cp, cc = to_t(copy), to_t(consts)
    zero = to_t(np.zeros(n, np.uint64))
    acc = (zero, zero)
    t = 0
    for gate, path in zip(gates, paths):
        prog = capture_gate_program(gate)
        gacc = (zero, zero)
        for inst in range(gate.num_repetitions(geometry)):
            off = inst * gate.principal_width
            row = RowView(lambda i, off=off: cp[off + i], None,
                          lambda i, path=path: cc[len(path) + i])
            for term in prog.evaluate(tfl.TensorOps, row):
                term = term if not isinstance(term, int) else gf.from_numpy(
                    np.full(n, term, np.uint64), "cpu")
                gacc = ext_f.add(gacc, (gf.mul(term, pows[t][0]), gf.mul(term, pows[t][1])))
                t += 1
        sel = qs.selector_from_consts(cc, path)
        acc = ext_f.add(acc, gacc if sel is None else ext_f.mul_by_base(gacc, sel))
    np.testing.assert_array_equal(got[0], to_np(acc[0]))
    np.testing.assert_array_equal(got[1], to_np(acc[1]))


def test_hash_gates_encode_within_the_kernel_limits():
    """The flat gates fit MAX_SLOTS (122 and 130 slots while terms waited);
    the legacy gate's constants are stored once each; the recursion
    geometry's two flat gates together need a program read from global
    memory and still fit a block's shared memory."""
    geometry = CSGeometry(*GEOM)
    got = {}
    for name, (gate, _jg) in NEW_GATES.items():
        prog, kvals, slots, _ops = qs.encode_gate_programs([gate.instance()], [[]], geometry,
                                                           130)
        got[name] = (slots, len(kvals), len(capture_gate_program(gate.instance()).consts))
    assert got == {"poseidon2_flat": (16, 130, 382), "poseidon_flat": (24, 368, 4680),
                   "ext_fma": (9, 1, 3)}
    gates = [Poseidon2FlattenedGate.instance(), PoseidonFlattenedGate.instance(),
             ExtFmaGate.instance()]
    plan = qs.SweepPlan.entry(qs.OracleLayout.build(geometry), gates, [[0], [1, 0], [1, 1]],
                              geometry, qs.GATES, "cpu")
    assert plan.num_slots == 24 and not qs.prog_in_shared(plan)
    for n in (1 << 16, 1 << 20):
        assert qs.shared_bytes(plan, *qs.launch_geometry(n, plan.parts)) <= qs.SMEM_BYTES

