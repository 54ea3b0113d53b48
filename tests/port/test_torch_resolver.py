"""boojum_tpu_torch's witness resolution against boojum_tpu's on the CPU.

- The resolver cases of tests/test_cs.py: deferred order, a waiter parked
  past the arena, a failed native batch poisoning the resolver, record and
  playback with divergence raised.
- Every op of the native tape against the Python closure of the gadget that
  names it, on random inputs (numpy seed), and OP_POSEIDON2 against the
  gate's `_witness_trace` (12 outputs, 106 auxiliaries).
- Assemblies word for word (tolerance 0: exact field elements) under the
  tape, under the Python resolver and from the JAX package.
- tests/test_aux.py's re-proving from an external witness, the lookups
  counted again, setup-only synthesis (placement as the JAX package's
  setup-mode assembly, the setup as the witnessed one's), pickling, and no
  fallback without a compiler.
"""

import hashlib
import pickle
import sys
from functools import lru_cache
from types import SimpleNamespace

import numpy as np
import pytest

from boojum_tpu.cs.gates import FmaGate as JFmaGate
from boojum_tpu.cs.gates import PublicInputGate as JPublicInputGate
from boojum_tpu.cs.implementations import ConstraintSystem as JConstraintSystem
from boojum_tpu.cs.types import SETUP_CS_CONFIG as JSETUP_CS_CONFIG
from boojum_tpu.cs.types import CSGeometry as JCSGeometry
from boojum_tpu.cs.types import LookupParameters as JLookupParameters
from boojum_tpu.examples import build_xor_lookup_circuit
from boojum_tpu.gadgets import allocate_u8_input as jallocate_u8_input
from boojum_tpu.gadgets import sha256 as jsha256
from boojum_tpu_torch import circuits as C
from boojum_tpu_torch import native
from boojum_tpu_torch.cs.gates import poseidon2_flat as tp2flat
from boojum_tpu_torch.cs.gates import simple as ts
from boojum_tpu_torch.cs.gates import u32 as tu32
from boojum_tpu_torch.cs.implementations import ConstraintSystem
from boojum_tpu_torch.cs.implementations import reference_cs
from boojum_tpu_torch.cs.types import SETUP_CS_CONFIG, CSGeometry
from boojum_tpu_torch.dag import (
    NativeTapeResolver, NullResolver, PlaybackResolver, WitnessResolver, make_resolver,
)
from boojum_tpu_torch.gadgets import UInt32, sha256_digest_bytes
from boojum_tpu_torch.gadgets.chunk_utils import decompose_and_check
from boojum_tpu_torch.gadgets.num import Num
from boojum_tpu_torch.prover import ProofConfig, generate_setup, prove, verify
from boojum_tpu_torch.prover.setup import (
    build_constant_columns, build_selector_tree, compute_sigma_values,
)
from boojum_tpu_torch.serialization import vk_to_json
from torch_port_util import P, assert_same_assembly, bench_function

RESOLVERS = {"python": lambda: WitnessResolver(), "native": lambda: make_resolver()}
GEOM = CSGeometry(16, 0, 6, 4)


def python_resolver(monkeypatch):
    """Synthesis in this test goes through the Python resolver."""
    monkeypatch.setattr(reference_cs, "make_resolver", lambda field: WitnessResolver())


# ---- tests/test_cs.py's resolver cases ------------------------------------------

@pytest.mark.parametrize("kind", RESOLVERS)
def test_deferred_resolution_order(kind):
    cs = ConstraintSystem(GEOM, 64, resolver=RESOLVERS[kind]())
    a = cs.alloc_variable_without_value()
    b = cs.alloc_variable_without_value()
    out = cs.alloc_variable_without_value()
    cs.set_values_with_dependencies([a, b], [out], lambda v: [(v[0] + v[1]) % P])
    cs.resolver.set_value(a, 10)
    assert not cs.resolver.is_resolved(out)
    cs.resolver.set_value(b, 20)
    assert cs.get_value(out) == 30


def test_native_flush_with_far_waiter():
    """A closure parked on a place past the arena must not break a flush."""
    r = make_resolver(capacity=16)
    assert isinstance(r, NativeTapeResolver)
    r.add_resolution([100000], [2], lambda v: [v[0] + 1])
    r.set_value(0, 7)
    r.add_resolution([], [1], None, native=(native.OP_CONST, (5,)))
    assert r.get_value(1) == 5
    r.set_value(100000, 9)
    assert r.get_value(2) == 10


def test_native_resolver_poison_on_failed_batch():
    """A lookup miss in a batch poisons the resolver: every later read
    raises the first error, chained."""
    r = make_resolver(capacity=64)
    r.set_value(0, 99)  # not a key of xor4 (keys are 0..15)
    r.set_value(1, 3)
    r.add_resolution([0, 1], [2], None, native=(native.OP_LOOKUP, (1,)), table=C.xor4_table())
    with pytest.raises(RuntimeError, match="native"):
        r.get_value(2)
    with pytest.raises(RuntimeError, match="native") as ei:
        r.get_value(2)
    assert ei.value.__cause__ is not None
    with pytest.raises(RuntimeError, match="native"):
        r.wait_till_resolved()
    with pytest.raises(RuntimeError, match="native"):
        r.values_flat(3)


@pytest.mark.parametrize("kind", RESOLVERS)
def test_resolution_record_playback(kind):
    """A recorded run replayed through PlaybackResolver gives the same
    witness; a synthesis that diverges from the record raises."""
    geom = CSGeometry(8, 0, 6, 4)

    def synthesize(cs):
        a = cs.alloc_variable_with_value(3)
        b = cs.alloc_variable_with_value(5)
        for _ in range(20):
            a, b = b, ts.FmaGate.fma(cs, a, b, a, 1, 1)
        flag = ts.ZeroCheckGate.is_zero(cs, b)
        return ts.FmaGate.fma(cs, b, b, flag, 1, 1)

    recorder = RESOLVERS[kind]()
    recorder.start_recording()
    cs1 = ConstraintSystem(geom, 1 << 10, resolver=recorder)
    out1 = synthesize(cs1)
    asm1 = cs1.into_assembly()
    record = recorder.resolution_record()
    assert sorted(record) == list(range(len(record))) and record
    cs2 = ConstraintSystem(geom, 1 << 10, resolver=PlaybackResolver(record))
    out2 = synthesize(cs2)
    assert cs2.get_value(out2) == cs1.get_value(out1)
    np.testing.assert_array_equal(asm1.copy_cols_values, cs2.into_assembly().copy_cols_values)
    cs3 = ConstraintSystem(geom, 1 << 10, resolver=PlaybackResolver(record))
    synthesize(cs3)
    cs3.alloc_variable_with_value(7)
    synthesize(cs3)
    with pytest.raises(RuntimeError, match="playback divergence"):
        cs3.resolver.wait_till_resolved()


# ---- each native op against its Python closure --------------------------------------

def _u32(cs, rng, n):
    return [cs.alloc_variable_with_value(int(v)) for v in rng.integers(0, 1 << 32, n)]


def _bits(cs, rng, n):
    return [cs.alloc_variable_with_value(int(v)) for v in rng.integers(0, 2, n)]


def _bytes(cs, rng, n):
    return [cs.alloc_variable_with_value(int(v)) for v in rng.integers(0, 256, n)]


def _felts(cs, rng, n):
    return [cs.alloc_variable_with_value(int(v)) for v in rng.integers(0, P, n, dtype=np.uint64)]


def op_const(cs, rng):
    return [ts.ConstantsAllocatorGate.allocate_constant(cs, int(rng.integers(0, P, dtype=np.uint64)))]


def op_fma(cs, rng):
    a, b, c = _felts(cs, rng, 3)
    return [ts.FmaGate.fma(cs, a, b, c, int(rng.integers(0, P, dtype=np.uint64)), 7)]


def op_reduction(cs, rng):
    cf = [int(v) for v in rng.integers(0, P, 4, dtype=np.uint64)]
    return [ts.ReductionGate.reduce(cs, _felts(cs, rng, 4), cf)]


def op_split(cs, rng):
    (x,) = _u32(cs, rng, 1)
    return (decompose_and_check(cs, x, 32) + [b.var for b in Num(x).spread_into_bits(cs, 32)]
            + [b.var for b in UInt32(x).to_le_bytes(cs)])


def op_u32_add(cs, rng):
    return list(tu32.U32AddGate.add(cs, *_u32(cs, rng, 2), *_bits(cs, rng, 1)))


def op_uintx_add(cs, rng):
    a16, b16 = (cs.alloc_variable_with_value(int(v)) for v in rng.integers(0, 1 << 16, 2))
    return [*tu32.UIntXAddGate(8).add(cs, *_bytes(cs, rng, 2), *_bits(cs, rng, 1)),
            *tu32.UIntXAddGate(16).add(cs, a16, b16, *_bits(cs, rng, 1))]


def op_u32_sub(cs, rng):
    return list(tu32.U32SubGate.sub(cs, *_u32(cs, rng, 2), *_bits(cs, rng, 1)))


def op_tri_add(cs, rng):
    return list(tu32.U32TriAddCarryAsChunkGate.add(cs, *_u32(cs, rng, 3)))


def op_u32_fma(cs, rng):
    return list(tu32.U32FmaGate.fma(cs, *_u32(cs, rng, 4)))


def op_byte_tri_add(cs, rng):
    outs, carry = tu32.ByteTriAddGate.add(cs, _bytes(cs, rng, 4), _bytes(cs, rng, 4),
                                          _bytes(cs, rng, 4))
    return [*outs, carry]


def op_poseidon2(cs, rng):
    return tp2flat.Poseidon2FlattenedGate.permutation(cs, _felts(cs, rng, 12))


def op_lookup(cs, rng):
    tid = cs.add_lookup_table(C.xor4_table())
    outs = []
    for a, b in rng.integers(0, 16, (12, 2)):
        outs += cs.perform_lookup(tid, [cs.alloc_variable_with_value(int(a)),
                                        cs.alloc_variable_with_value(int(b))])
    return outs


OPS = {"const": op_const, "fma": op_fma, "reduction": op_reduction, "split": op_split,
       "u32_add": op_u32_add, "uintx_add": op_uintx_add, "u32_sub": op_u32_sub,
       "tri_add": op_tri_add, "u32_fma": op_u32_fma, "byte_tri_add": op_byte_tri_add,
       "poseidon2": op_poseidon2, "lookup": op_lookup}


@pytest.mark.parametrize("op", OPS)
def test_native_op_matches_python_closure(op, monkeypatch):
    """The op's outputs through the tape equal the gadget's closure's on the
    same random inputs; on the tape no Python closure runs at all."""
    geom = CSGeometry(130, 0, 8, 7)
    lookups = C.SHA256_LOOKUP if op in ("split", "u32_fma", "lookup") else None
    runs = {}
    for kind in RESOLVERS:
        cs = ConstraintSystem(geom, 1 << 14, lookup_params=lookups, resolver=RESOLVERS[kind]())
        if kind == "native":
            # every typed op on the tape, the scalar ones too
            monkeypatch.setattr(NativeTapeResolver, "TAPE_OPS", frozenset(native.OP_NAMES))
            monkeypatch.setattr(NativeTapeResolver, "_run", None)
            monkeypatch.setattr(NativeTapeResolver, "_write", None)
        outs = OPS[op](cs, np.random.default_rng(29))
        monkeypatch.undo()
        asm = cs.into_assembly()
        runs[kind] = ([cs.get_value(v) for v in outs], asm)
    assert runs["native"][0] == runs["python"][0]
    (_, a), (_, b) = runs["native"], runs["python"]
    np.testing.assert_array_equal(a.copy_cols_values, b.copy_cols_values)
    if lookups:
        np.testing.assert_array_equal(a.multiplicities, b.multiplicities)
        np.testing.assert_array_equal(a.lookup_cols_values, b.lookup_cols_values)


def test_op_poseidon2_matches_witness_trace():
    rng = np.random.default_rng(31)
    for state in ([0] * 12, [P - 1] * 12, [int(v) for v in rng.integers(0, P, 12, dtype=np.uint64)]):
        r = make_resolver()
        for i, v in enumerate(state):
            r.set_value(2 * i, v)
        outs = [2 * (12 + i) for i in range(12 + tp2flat.NUM_AUX)]
        r.add_resolution([2 * i for i in range(12)], outs, None,
                         native=(native.OP_POSEIDON2, ()))
        out, aux = tp2flat._witness_trace(state)
        assert [r.get_value(p) for p in outs] == out + aux


# ---- assemblies: tape, Python resolver, JAX package ----------------------------------

def jax_fma(m, config=None):
    """bench.py's fma chain at 2^8 over namespace m (config: setup-only)."""
    geom = m.CSGeometry(16, 0, 6, 3)
    cs = (m.ConstraintSystem(geom, 1 << 8) if config is None
          else m.ConstraintSystem(geom, 1 << 8, config))
    a = cs.alloc_variable_with_value(1)
    b = cs.alloc_variable_with_value(2)
    for _ in range((256 - 8) * m.FmaGate.instance().num_repetitions(geom)):
        a, b = b, m.FmaGate.fma(cs, a, b, a, 1, 1)
    m.PublicInputGate.place(cs, b)
    return cs


JFMA = SimpleNamespace(ConstraintSystem=JConstraintSystem, CSGeometry=JCSGeometry,
                       FmaGate=JFmaGate, PublicInputGate=JPublicInputGate)


def jax_sha_abc(config=None):
    geom, lp = JCSGeometry(60, 0, 8, 7), JLookupParameters(width=4, num_repetitions=8)
    cs = (JConstraintSystem(geom, 1 << 17, lookup_params=lp) if config is None
          else JConstraintSystem(geom, 1 << 17, config, lookup_params=lp))
    jsha256(cs, jallocate_u8_input(cs, b"abc"))
    return cs


def _jax_zoo():
    from test_torch_gates_u32 import jax_zoo_namespace

    return C.gate_zoo(jax_zoo_namespace(), 8)[0]


def _jax_chain():
    from test_torch_poseidon_gates import JNS, chain

    return chain(JNS, False)[0]


def _jax_general():
    from test_lookup_general import build_circuit

    return build_circuit()[0]


def _jax_witness():
    from test_witness_columns import build_circuit

    return build_circuit()[0]


CIRCUITS = {
    "fma 2^8": (lambda: C.build_fma(8), lambda: bench_function("build_fma")(8)),
    "xor4 2^9": (lambda: C.build_xor_lookup()[0],
                 lambda: build_xor_lookup_circuit(30, geometry=JCSGeometry(8, 0, 6, 4),
                                                  lookup_params=JLookupParameters(3, 2))[0]),
    "general lookups 2^9": (lambda: C.build_general_lookup()[0], _jax_general),
    "witness columns 2^5": (lambda: C.build_zero_check_witness()[0], _jax_witness),
    "gate zoo 2^8": (lambda: C.build_gate_zoo(8)[0], _jax_zoo),
    "sha256 abc": (lambda: C.build_sha256(message=b"abc")[0], jax_sha_abc),
    "poseidon2 chain 2^10": (lambda: C.build_permutation_chain()[0], _jax_chain),
}


@pytest.mark.parametrize("circuit", CIRCUITS)
def test_assembly_same_under_tape_python_and_jax(circuit, monkeypatch):
    port, jax = CIRCUITS[circuit]
    tape_cs = port()
    assert isinstance(tape_cs.resolver, NativeTapeResolver)
    tape = tape_cs.into_assembly()
    python_resolver(monkeypatch)
    py_cs = port()
    assert type(py_cs.resolver) is WitnessResolver
    py = py_cs.into_assembly()
    ja = jax().into_assembly()
    for asm in (tape, py):
        assert_same_assembly(asm, ja)
        np.testing.assert_array_equal(asm.wit_placement, ja.wit_placement)
        np.testing.assert_array_equal(asm.wit_cols_values, ja.wit_cols_values)
    np.testing.assert_array_equal(tape.witness_vec(), py.witness_vec())


# ---- re-proving from an external witness (tests/test_aux.py) ---------------------------

E2E_CONFIG = ProofConfig(fri_lde_factor=8, merkle_tree_cap_size=4, num_queries=20,
                         pow_bits=0, fri_final_degree=4)


def fibonacci_select(a0, b0):
    """tests/test_aux.py's re-witnessed circuit: five Fibonacci-FMA steps
    from (a0, b0), a boolean flag selecting the last value, public."""
    cs = ConstraintSystem(CSGeometry(8, 0, 6, 4), 1 << 10)
    a = cs.alloc_variable_with_value(a0)
    b = cs.alloc_variable_with_value(b0)
    flag = cs.alloc_variable_with_value(1)
    ts.BooleanConstraintGate.enforce(cs, flag)
    for _ in range(5):
        a, b = b, ts.FmaGate.fma(cs, a, b, a, 1, 1)
    ts.PublicInputGate.place(cs, ts.SelectionGate.select(cs, flag, a, b))
    return cs


@lru_cache(maxsize=1)
def fibonacci_run():
    asm = C.fibonacci(C.port_recursion_namespace(), steps=40)[0].into_assembly()
    setup = generate_setup(asm, E2E_CONFIG, device="cpu")
    return asm, setup, prove(asm, setup, E2E_CONFIG, device="cpu")


def test_external_witness_reprove():
    asm, setup, proof = fibonacci_run()
    asm2 = asm.with_external_witness(asm.witness_vec())
    proof2 = prove(asm2, setup, E2E_CONFIG, device="cpu")
    assert verify(setup.vk, proof2, asm.gates)
    assert proof2.to_json() == proof.to_json()


def test_external_witness_reprove_changed_values():
    asm = fibonacci_select(1, 2).into_assembly()
    setup = generate_setup(asm, E2E_CONFIG, device="cpu")
    p1 = prove(asm, setup, E2E_CONFIG, device="cpu")
    asm2 = asm.with_external_witness(fibonacci_select(5, 9).into_assembly().witness_vec())
    p2 = prove(asm2, setup, E2E_CONFIG, device="cpu")
    assert verify(setup.vk, p1, asm.gates) and verify(setup.vk, p2, asm.gates)
    assert p2.public_inputs != p1.public_inputs
    assert p2.witness_cap != p1.witness_cap


@pytest.mark.parametrize("circuit", ["xor4 2^9", "general lookups 2^9", "sha256 abc"])
def test_external_witness_counts_lookups_again(circuit):
    """The multiplicities counted from the placed tuples of a witness
    vector equal the ones synthesis counted."""
    asm = CIRCUITS[circuit][0]().into_assembly()
    again = asm.with_external_witness(asm.witness_vec())
    assert asm.lookup_mode != "none"
    np.testing.assert_array_equal(again.multiplicities, asm.multiplicities)
    for name in ("copy_cols_values", "wit_cols_values", "lookup_cols_values"):
        np.testing.assert_array_equal(getattr(again, name), getattr(asm, name))
    assert again.public_inputs == asm.public_inputs and again.resolver is None


def test_sha256_witness_of_another_message():
    """A witness vector of sha256 over another message proves against the
    first circuit's placement: its digest places hold hashlib's digest."""
    cs1, d1 = C.build_sha256(message=b"abc")
    cs2, d2 = C.build_sha256(message=b"xyz")
    assert d1 == d2
    other = cs2.into_assembly()
    wv = other.witness_vec()
    assert bytes(int(wv[p]) for p in d1) == hashlib.sha256(b"xyz").digest()
    again = cs1.into_assembly().with_external_witness(wv)
    for name in ("copy_cols_values", "lookup_cols_values", "multiplicities"):
        np.testing.assert_array_equal(getattr(again, name), getattr(other, name))


# ---- setup-only synthesis ------------------------------------------------------------

PLACEMENT = ("row_gate", "copy_placement", "lookup_placement", "lookup_table_id_col")


@pytest.mark.parametrize("circuit", ["fma 2^8", "sha256 abc"])
def test_setup_mode_placement_and_setup(circuit):
    if circuit == "fma 2^8":
        setup_cs, witnessed = C.build_fma(8, config=SETUP_CS_CONFIG), C.build_fma(8)
        jsetup = jax_fma(JFMA, JSETUP_CS_CONFIG)
    else:
        setup_cs = C.build_sha256(message=b"abc", config=SETUP_CS_CONFIG)[0]
        witnessed = C.build_sha256(message=b"abc")[0]
        jsetup = jax_sha_abc(JSETUP_CS_CONFIG)
    assert isinstance(setup_cs.resolver, NullResolver)
    sa, wa, ja = setup_cs.into_assembly(), witnessed.into_assembly(), jsetup.into_assembly()
    for name in PLACEMENT:
        a, b, c = (getattr(x, name) for x in (sa, wa, ja))
        if c is None:
            assert a is None and b is None, name
        else:
            np.testing.assert_array_equal(a, c, err_msg=name)
            np.testing.assert_array_equal(b, c, err_msg=name)
    assert sa.gate_constants == wa.gate_constants == ja.gate_constants
    assert [g.name for g in sa.gates] == [g.name for g in ja.gates]
    assert sa.public_inputs == [tuple(p) for p in ja.public_inputs]
    assert not sa.copy_cols_values.any()
    if sa.multiplicities is not None:
        assert not sa.multiplicities.any()
    if circuit == "fma 2^8":
        cfg = C.fma_proof_config()
        assert (vk_to_json(generate_setup(sa, cfg, device="cpu").vk)
                == vk_to_json(generate_setup(wa, cfg, device="cpu").vk))
    else:
        # what the VK commits: sigmas, constants with the table ids, tables
        _, paths = build_selector_tree(sa.gates)
        cols = [np.concatenate([
            compute_sigma_values(np.concatenate([asm.copy_placement, asm.lookup_placement])),
            build_constant_columns(asm, paths), asm.lookup_table_id_col[None, :],
            asm.stacked_table_columns(asm.lookup_params.width)]) for asm in (sa, wa)]
        np.testing.assert_array_equal(cols[0], cols[1])


# ---- pickling, the engine, no fallback ----------------------------------------------

def test_pickled_assembly_drops_its_resolver():
    asm = C.build_xor_lookup()[0].into_assembly()
    wv = asm.witness_vec()
    back = pickle.loads(pickle.dumps(asm))
    assert back.resolver is None and asm.resolver is not None
    with pytest.raises(RuntimeError, match="witness_vec"):
        back.witness_vec()
    np.testing.assert_array_equal(back.with_external_witness(wv).multiplicities,
                                  asm.multiplicities)


@pytest.mark.parametrize("field,resolver", [("goldilocks", NativeTapeResolver),
                                            ("babybear", WitnessResolver)])
def test_make_resolver_by_field(field, resolver):
    assert type(make_resolver(field)) is resolver
    assert type(C.build_fma(4, field=field).resolver) is resolver


def test_no_fallback_without_a_compiler(monkeypatch):
    monkeypatch.setattr(native, "CXX", "no-such-cxx-compiler")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="no-such-cxx-compiler"):
        make_resolver("goldilocks")
    with pytest.raises(RuntimeError, match="no-such-cxx-compiler"):
        C.build_fma(4)
    assert type(make_resolver("babybear")) is WitnessResolver
    assert not native.library_path().exists()


def test_engine_builds_outside_the_source_tree():
    path = native.library_path()
    native.get_lib()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("resolver-") and path.suffix == ".so"
    assert not list(native.SRC.parent.glob("*.so"))


def test_async_batches_match_inline():
    """Batches past ASYNC_THRESHOLD run on the worker thread while synthesis
    appends, reads and grows the arena (thread switches forced often); the
    witness is the one inline batches give."""
    words = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for threshold in (8, 1 << 30):
            r = make_resolver(capacity=64)
            r.ASYNC_THRESHOLD = threshold
            cs = ConstraintSystem(GEOM, 1 << 12, resolver=r)
            a, b = cs.alloc_variable_with_value(3), cs.alloc_variable_with_value(5)
            zero = cs.zero_var()
            # each add reads the last one's output, pending on the tape
            for i in range(2000):
                a, b = b, tu32.U32AddGate.add(cs, a, b, zero)[0]
                if i % 97 == 0:
                    assert cs.get_value(b) < 1 << 32
            words[threshold] = cs.into_assembly().witness_vec()
    finally:
        sys.setswitchinterval(interval)
    np.testing.assert_array_equal(words[8], words[1 << 30])


def test_scalar_ops_run_at_once_unless_an_input_is_pending():
    """On the tape's resolver an fma over resolved inputs is written at once;
    one over an output pending on the tape goes on the tape behind it."""
    cs = ConstraintSystem(GEOM, 1 << 10, resolver=make_resolver())
    a, b = cs.alloc_variable_with_value(P - 2), cs.alloc_variable_with_value(5)
    d = ts.FmaGate.fma(cs, a, b, a, 3, 4)
    assert cs.resolver.state[d] == 1 and cs.resolver._tape.num_ops == 0
    s, _carry = tu32.U32AddGate.add(cs, b, b, cs.zero_var())
    e = ts.FmaGate.fma(cs, s, d, b, 1, 1)
    assert cs.resolver.state[e] == 2 and cs.resolver._tape.num_ops == 2
    want_d = (3 * (P - 2) * 5 + 4 * (P - 2)) % P
    assert cs.get_value(d) == want_d and cs.get_value(e) == (10 * want_d + 5) % P


def test_digest_under_the_tape_is_hashlib():
    cs, digest = C.build_sha256(message=b"hello tape")
    assert sha256_digest_bytes(cs, digest) == hashlib.sha256(b"hello tape").digest()
