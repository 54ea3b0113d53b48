"""The port's gates of cs/gates/simple.py and cs/gates/u32.py against
boojum_tpu's, and the gate zoo that places them all (CPU).

- Each gate's shape and captured program equal the JAX gate's.
- The sweep's encoding (quotient_sweep.encode_gate_programs, slots reused by
  liveness) fits every gate within its 32 slots, the 12×12 matrix gate
  included, and refuses a gate that needs more; the plain interpreter of
  the encoded table gives each term of each instance equal to the JAX
  gate's `evaluate` over host ints on random rows (numpy seed).
- The Boolean, Num and UInt gadgets synthesize the JAX package's circuits
  (tests/test_gadgets.py) word for word, and both packages' satisfiability
  checks agree on them; the port's check also holds the earlier slices'
  circuits (each lookup mode, witness columns, BabyBear) and refuses each
  with one cell changed.
- The gate zoo (circuits.gate_zoo) at 2^8 rows synthesized by both
  packages from one seed is the same assembly; set up and proved by each, its checkpoint
  stream and proof JSON are equal, and each verifier accepts the other's
  proof. Tolerance 0 throughout: exact field elements.
"""

import copy
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from boojum_tpu import gadgets as jgadgets
from boojum_tpu.cs import field_like as jfl
from boojum_tpu.cs.gate_capture import capture_gate_program as jcapture
from boojum_tpu.cs.gates import base as jbase
from boojum_tpu.cs.gates import simple as jsimple
from boojum_tpu.cs.gates import u32 as ju32
from boojum_tpu.cs.implementations import ConstraintSystem as JConstraintSystem
from boojum_tpu.cs.types import CSGeometry as JCSGeometry
from boojum_tpu.cs.types import LookupParameters as JLookupParameters
from boojum_tpu.prover.satisfiability import check_if_satisfied as jcheck
from boojum_tpu_torch import gadgets as tgadgets
from boojum_tpu_torch.circuits import (
    GATE_ZOO_GEOMETRY, ZOO_GATES, build_gate_zoo, gate_zoo, gate_zoo_proof_config,
)
from boojum_tpu_torch.compat import port_gate
from boojum_tpu_torch.cs.gate_capture import capture_gate_program
from boojum_tpu_torch.cs.gates import simple as tsimple
from boojum_tpu_torch.cs.gates import u32 as tu32
from boojum_tpu_torch.cs.implementations import ConstraintSystem
from boojum_tpu_torch.cs.types import CSGeometry, LookupParameters
from boojum_tpu_torch.prover import quotient_sweep as qs
from boojum_tpu_torch.prover.satisfiability import check_if_satisfied
from torch_port_util import BOUNDARY, assert_same_assembly, rand_words, to_np, to_t

P = 0xFFFFFFFF00000001
MATRIX12 = [[int(v) for v in row]
            for row in np.random.default_rng(12).integers(0, P, (12, 12), dtype=np.uint64)]


def _gate_pairs():
    """(id, JAX gate, port gate) for every gate of simple.py and u32.py
    that has terms or a shape of its own."""
    pairs = []
    for name in ("BooleanConstraintGate", "ReductionByPowersGate", "SelectionGate",
                 "ParallelSelectionGate", "ConditionalSwapGate", "DotProductGate",
                 "QuadraticCombinationGate", "ZeroCheckGate", "SimpleNonlinearityGate",
                 "FmaGate", "ConstantsAllocatorGate", "ReductionGate",
                 "ZeroCheckWitnessGate", "NopGate", "PublicInputGate"):
        pairs.append((name, getattr(jsimple, name).instance(),
                      getattr(tsimple, name).instance()))
    for name in ("U32AddGate", "U32SubGate", "U32FmaGate", "U32TriAddCarryAsChunkGate",
                 "ByteTriAddGate"):
        pairs.append((name, getattr(ju32, name).instance(), getattr(tu32, name).instance()))
    for bits in (8, 16, 32):
        jg = ju32.UIntXAddGate(bits)
        pairs.append((f"UIntXAddGate{bits}", jg, port_gate(jg)))
    for n, matrix in ((3, [[2, 1, 1], [1, 2, 1], [1, 1, 2]]), (12, MATRIX12)):
        jg = jsimple.MatrixMultiplicationGate(f"m{n}", matrix)
        pairs.append((f"MatrixMultiplicationGate{n}", jg, port_gate(jg)))
    jg = jsimple.ExplicitConstantsAllocatorGate((5, 1 << 32))
    pairs.append(("ExplicitConstantsAllocatorGate", jg, port_gate(jg)))
    jg = jsimple.BoundedGateWrapper(jsimple.FmaGate.instance(), 3)
    pairs.append(("BoundedGateWrapper", jg, port_gate(jg)))
    return pairs


PAIRS = {name: (jg, tg) for name, jg, tg in _gate_pairs()}
WITH_TERMS = sorted(n for n, (jg, _tg) in PAIRS.items() if jg.num_terms)
# wide enough for every gate: the 12×12 matrix gate takes 24 copy columns
GEOMETRY = CSGeometry(24, 2, 6, 8)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_gate_shape_and_captured_program_match_jax(name):
    jg, tg = PAIRS[name]
    for attr in ("name", "principal_width", "witness_width", "num_constants", "num_terms",
                 "max_degree"):
        assert getattr(tg, attr) == getattr(jg, attr), attr
    got, want = capture_gate_program(tg), jcapture(jg)
    fields = ("loads", "consts", "ops", "terms", "num_slots")
    assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}


def test_rebuilt_parametrised_gates_keep_their_parameters():
    jg = jsimple.BoundedGateWrapper(ju32.UIntXAddGate(16), 7)
    tg = port_gate(jg)
    assert (tg.name, tg.max_rows, tg.inner.width_bits) == ("bounded_uint16_add", 7, 16)
    assert port_gate(PAIRS["MatrixMultiplicationGate12"][0]).matrix == [
        [v % P for v in row] for row in MATRIX12]
    assert port_gate(PAIRS["ExplicitConstantsAllocatorGate"][0]).constants == [
        0, 1, P - 1, 5, 1 << 32]
    with pytest.raises(NotImplementedError):
        port_gate("no_such_gate")


def _renamed(gate, name):
    gate = copy.copy(gate)
    gate.name = name
    return gate


@pytest.mark.parametrize("case", ["matrix without prefix", "matrix not reduced",
                                  "constants reordered", "width renamed"])
def test_rebuilt_gate_that_does_not_match_raises(case):
    """A JAX gate whose name or parameters would not carry over is refused,
    not rebuilt as another gate."""
    matrix = PAIRS["MatrixMultiplicationGate3"][0]
    consts = copy.copy(PAIRS["ExplicitConstantsAllocatorGate"][0])
    consts.constants = [1, 0] + consts.constants[2:]
    unreduced = copy.copy(matrix)
    unreduced.matrix = [[v + P for v in row] for row in matrix.matrix]
    gate = {"matrix without prefix": _renamed(matrix, "m3"),
            "matrix not reduced": unreduced,
            "constants reordered": consts,
            "width renamed": _renamed(ju32.UIntXAddGate(8), "uint16_add")}[case]
    with pytest.raises(ValueError):
        port_gate(gate)


@pytest.mark.parametrize("name", WITH_TERMS)
def test_encoding_fits_32_slots(name):
    _jg, tg = PAIRS[name]
    p = capture_gate_program(tg)
    _prog, _kvals, slots, _ops = qs.encode_gate_programs([tg], [[]], GEOMETRY, 24)
    ins, terms, live = qs.schedule_program(p)
    assert slots == live <= qs.MAX_SLOTS
    assert len(terms) == tg.num_terms
    # the schedule runs every op of the program once, each load and
    # constant at most once, and folds each term once
    assert sum(1 for op, *_ in ins if isinstance(op, str)) == len(p.ops)
    assert (sum(1 for op, *_ in ins if op[0] in ("load", "const"))
            <= len(p.loads) + len(p.consts))
    assert sorted(op[1] for op, *_ in ins if op[0] == "term") == list(range(tg.num_terms))


def test_matrix12_needs_24_slots_not_480():
    """Its 12 inputs, a product and a partial sum: 14 slots, now that each
    finished term is folded at once (24 while the 12 terms waited for the
    program's end)."""
    p = capture_gate_program(PAIRS["MatrixMultiplicationGate12"][1])
    assert p.num_slots == 480
    assert qs.schedule_program(p)[2] == 14


def test_encoding_refuses_a_gate_past_32_live_slots():
    """A 31×31 matrix gate holds its 31 inputs, a product and a partial sum
    at once: 33 slots, refused with the gate's name."""
    gate = tsimple.MatrixMultiplicationGate("m31", [[1 + i + j for j in range(31)]
                                                    for i in range(31)])
    with pytest.raises(ValueError, match=r"gate matmul_m31: 33 slots > 32"):
        qs.encode_gate_programs([gate], [[]], CSGeometry(62, 0, 6, 8), 62)


@pytest.mark.parametrize("name", WITH_TERMS)
def test_encoded_program_terms_match_jax_evaluate(name):
    """Each term of each instance, isolated by an alpha table with one 1:
    the plain interpreter of the encoded table against the JAX gate's
    evaluate over host ints, row by row (boundary words in the first
    rows)."""
    jg, tg = PAIRS[name]
    rng = np.random.default_rng(len(name))
    n = 6
    reps = tg.num_repetitions(GEOMETRY)
    copy = rand_words(rng, 24, n)
    copy[:3, 0] = BOUNDARY[:3]
    wit, consts = rand_words(rng, 2, n), rand_words(rng, 6, n)
    fn = qs.gate_terms_fn([tg], [[]], GEOMETRY, "cpu")
    T = reps * tg.num_terms
    for t in range(T):
        pows = [(1, 0) if i == t else (0, 0) for i in range(T)]
        got = to_np(fn(to_t(copy), to_t(wit), to_t(consts), pows)[0])
        inst, term = divmod(t, tg.num_terms)
        for r in range(n):
            dst = jbase.TermsCollector()
            col = lambda arr, off: (lambda i: int(arr[off + i, r]))  # noqa: E731
            jg.evaluate(jfl.ScalarOps, jbase.RowView(
                col(copy, inst * tg.principal_width), col(wit, inst * tg.witness_width),
                col(consts, 0)), dst)
            assert int(got[r]) == int(dst.terms[term]) % P, (t, r)


# ---- gadgets: the JAX package's tests/test_gadgets.py circuits -------------

def _gadget_circuit(ns, which):
    """The circuits of tests/test_gadgets.py over the classes of `ns`."""
    geometry = ns.CSGeometry(16, 0, 8, 4)
    lookups = ns.LookupParameters(width=4, num_repetitions=2) if which == "uint" else None
    cs = ns.ConstraintSystem(geometry, 1 << 13, lookup_params=lookups)
    values = []
    if which == "boolean":
        for av in (0, 1):
            for bv in (0, 1):
                a, b = ns.Boolean.allocate(cs, bool(av)), ns.Boolean.allocate(cs, bool(bv))
                for out in (a.and_(cs, b), a.or_(cs, b), a.xor(cs, b), a.negate(cs)):
                    values.append(out.get_value(cs))
    elif which == "num":
        rng = np.random.default_rng(3)
        for _ in range(10):
            x = int(rng.integers(0, P, dtype=np.uint64))
            y = int(rng.integers(0, P, dtype=np.uint64))
            a, b = ns.Num.allocate(cs, x), ns.Num.allocate(cs, y)
            values += [a.add(cs, b).get_value(cs), a.sub(cs, b).get_value(cs),
                       a.mul(cs, b).get_value(cs), a.equals(cs, b).get_value(cs),
                       a.equals(cs, ns.Num.allocate(cs, x)).get_value(cs)]
        lc = ns.Num.linear_combination(cs, [ns.Num.allocate(cs, v) for v in (5, 7, 11, 13)],
                                       [1, 2, 3, 4])
        values.append(lc.get_value(cs))
        values += [b.get_value(cs) for b in ns.Num.allocate(cs, 0b1011).spread_into_bits(cs, 6)]
    else:
        a = ns.UInt32.allocate_checked(cs, 0xDEADBEEF)
        b = ns.UInt32.allocate_checked(cs, 0x12345678)
        s, cout = a.add(cs, b)
        d, bout = a.sub(cs, b)
        lo, hi = a.fma(cs, b, ns.UInt32.allocate_checked(cs, 7))
        bs = [ns.UInt8.allocate_checked(cs, v) for v in (0xDE, 0xAD, 0xBE, 0xEF)]
        w = ns.UInt32.from_be_bytes(cs, bs)
        values += [x.get_value(cs) for x in (s, cout, d, bout, lo, hi, w, *w.to_le_bytes(cs))]
    return cs, values


JNS = SimpleNamespace(ConstraintSystem=JConstraintSystem, CSGeometry=JCSGeometry,
                      LookupParameters=JLookupParameters, **{
                          k: getattr(jgadgets, k) for k in ("Boolean", "Num", "UInt8",
                                                            "UInt16", "UInt32")})
TNS = SimpleNamespace(ConstraintSystem=ConstraintSystem, CSGeometry=CSGeometry,
                      LookupParameters=LookupParameters, **{
                          k: getattr(tgadgets, k) for k in ("Boolean", "Num", "UInt8",
                                                            "UInt16", "UInt32")})
@pytest.mark.parametrize("which", ["boolean", "num", "uint"])
def test_gadget_circuits_match_jax(which):
    jcs, jvals = _gadget_circuit(JNS, which)
    tcs, tvals = _gadget_circuit(TNS, which)
    assert [int(v) for v in tvals] == [int(v) for v in jvals]
    ja, ta = jcs.into_assembly(), tcs.into_assembly()
    assert_same_assembly(ta, ja)
    assert check_if_satisfied(ta) and jcheck(ja)
    for asm in (ta, ja):  # the first cell of the first gate, off by 2 (not 0 or 1)
        asm.copy_cols_values[0, 0] = (int(asm.copy_cols_values[0, 0]) + 2) % P
    assert not check_if_satisfied(ta) and not jcheck(ja)


def test_uint_without_lookups_range_checks_by_booleans():
    cs = ConstraintSystem(CSGeometry(16, 0, 8, 4), 1 << 10)
    x = tgadgets.UInt16.allocate_checked(cs, 0xBEEF)
    assert x.get_value(cs) == 0xBEEF
    assert "boolean" in [g.name for g in cs.gates]
    assert check_if_satisfied(cs.into_assembly())


# ---- the gate zoo: both packages synthesize, set up, prove, verify ----------

def jax_zoo_namespace():
    return SimpleNamespace(ConstraintSystem=JConstraintSystem, CSGeometry=JCSGeometry,
                           Boolean=jgadgets.Boolean, Num=jgadgets.Num, UInt8=jgadgets.UInt8,
                           UInt16=jgadgets.UInt16, UInt32=jgadgets.UInt32,
                           **{name: getattr(jsimple, name, None) or getattr(ju32, name)
                              for name in ZOO_GATES})


CONFIG = dataclasses.asdict(gate_zoo_proof_config())
ZOO_LOG_N = 8  # two rounds of the zoo


@pytest.fixture(scope="module")
def jax_zoo():
    from boojum_tpu.prover import ProofConfig as JProofConfig
    from boojum_tpu.prover import generate_setup as jgenerate_setup
    from boojum_tpu.prover import prove as jprove
    from boojum_tpu.utils.report import CheckpointLog as JCheckpointLog
    from boojum_tpu.utils.report import install_checkpoint_log

    cs, _pi = gate_zoo(jax_zoo_namespace(), ZOO_LOG_N)
    asm = cs.into_assembly()
    cfg = JProofConfig(**CONFIG)
    setup = jgenerate_setup(asm, cfg)
    log = JCheckpointLog()
    prev = install_checkpoint_log(log)
    try:
        proof = jprove(asm, setup, cfg)
    finally:
        install_checkpoint_log(prev)
    stream = [(e["round"], e["label"], e["digest"]) for e in log.entries]
    return SimpleNamespace(asm=asm, setup=setup, proof=proof, stream=stream)


@pytest.fixture(scope="module")
def port_zoo():
    from boojum_tpu_torch.prover import ProofConfig, generate_setup, prove
    from boojum_tpu_torch.utils.report import CheckpointLog

    cs, _pi = build_gate_zoo(ZOO_LOG_N)
    asm = cs.into_assembly()
    cfg = ProofConfig(**CONFIG)
    setup = generate_setup(asm, cfg, device="cpu")
    log = CheckpointLog()
    proof = prove(asm, setup, cfg, device="cpu", log=log)
    return SimpleNamespace(asm=asm, setup=setup, proof=proof, stream=log.stream())


def test_zoo_places_every_gate():
    cs, _pi = build_gate_zoo()
    names = {g.name for g in cs.gates}
    parametrised = ("MatrixMultiplicationGate", "ExplicitConstantsAllocatorGate",
                    "BoundedGateWrapper", "UIntXAddGate32")
    expected = {tg.name for name, (_jg, tg) in PAIRS.items()
                if not name.startswith(parametrised)
                and name not in ("NopGate", "ZeroCheckWitnessGate")}
    assert expected <= names
    for prefix in ("matmul_", "explicit_constants[", "bounded_fma"):
        assert any(n.startswith(prefix) for n in names), prefix
    assert cs.into_assembly().trace_len == 1 << 7
    assert dataclasses.astuple(GATE_ZOO_GEOMETRY) == (24, 0, 10, 8)


@pytest.mark.parametrize("log_n", [8, 9, 10])
def test_zoo_fills_its_rows(log_n):
    cs, _pi = build_gate_zoo(log_n)
    assert (1 << (log_n - 1)) < cs.next_row <= (1 << log_n)
    assert check_if_satisfied(cs.into_assembly())


def test_zoo_assembly_and_setup_match_jax(jax_zoo, port_zoo):
    assert port_zoo.asm.trace_len == 1 << ZOO_LOG_N
    assert_same_assembly(port_zoo.asm, jax_zoo.asm)
    js, ts = jax_zoo.setup, port_zoo.setup
    assert ts.selector_paths == js.selector_paths
    np.testing.assert_array_equal(ts.sigma_cols, js.sigma_cols)
    np.testing.assert_array_equal(ts.constant_cols, js.constant_cols)
    assert ts.vk.setup_merkle_cap == js.vk.setup_merkle_cap
    assert ts.vk.quotient_degree == js.vk.quotient_degree


def test_zoo_satisfiability_matches_jax(jax_zoo, port_zoo):
    assert check_if_satisfied(port_zoo.asm) and jcheck(jax_zoo.asm)


def test_zoo_checkpoint_stream_matches_jax(jax_zoo, port_zoo):
    assert port_zoo.stream == jax_zoo.stream


def test_zoo_proof_bytes_match_jax(jax_zoo, port_zoo):
    assert port_zoo.proof.to_json() == jax_zoo.proof.to_json()


def test_zoo_verifiers_accept_each_others_proofs(jax_zoo, port_zoo):
    from boojum_tpu.prover import verify as jverify
    from boojum_tpu.prover.proof import Proof as JProof
    from boojum_tpu_torch.prover import verify
    from boojum_tpu_torch.prover.proof import Proof

    assert verify(port_zoo.setup.vk, Proof.from_json(jax_zoo.proof.to_json()),
                  port_zoo.asm.gates)
    assert jverify(jax_zoo.setup.vk, JProof.from_json(port_zoo.proof.to_json()),
                   jax_zoo.asm.gates)


@pytest.mark.parametrize("circuit", ["fma", "xor4", "general", "witness", "babybear xor4"])
def test_satisfiability_check_on_the_earlier_circuits(circuit):
    """The port's check accepts the earlier slices' circuits (no lookups,
    specialized and general-purpose-column lookups, witness columns,
    BabyBear) and refuses each with one gate cell, one lookup cell or one
    multiplicity changed."""
    from boojum_tpu_torch.circuits import (
        build_fma, build_general_lookup, build_xor_lookup, build_zero_check_witness,
    )

    cs = {"fma": lambda: build_fma(8),
          "xor4": lambda: build_xor_lookup()[0],
          "general": lambda: build_general_lookup()[0],
          "witness": lambda: build_zero_check_witness()[0],
          "babybear xor4": lambda: build_xor_lookup(field="babybear")[0]}[circuit]()
    asm = cs.into_assembly()
    assert check_if_satisfied(asm)
    p = cs.p
    gid = next(i for i, g in enumerate(asm.gates) if g.num_terms)
    row = int(np.nonzero(asm.row_gate == gid)[0][0])
    changes = [("copy_cols_values", (0, row))]
    if asm.lookups_enabled:
        where = (0, 0) if asm.lookup_mode == "specialized" else None
        if where is None:  # a tuple cell on the first marker row
            mk = int(np.nonzero(asm.row_gate == asm.lookup_marker_gid())[0][0])
            changes.append(("copy_cols_values", (0, mk)))
        else:
            changes.append(("lookup_cols_values", where))
        changes.append(("multiplicities", (int(np.nonzero(asm.multiplicities)[0][0]),)))
    for name, at in changes:
        bad = copy.copy(asm)
        setattr(bad, name, getattr(asm, name).copy())
        getattr(bad, name)[at] = (int(getattr(bad, name)[at]) + 1) % p
        assert not check_if_satisfied(bad), name
