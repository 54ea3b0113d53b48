"""boojum_tpu_torch's recursive verifier against boojum_tpu's (CPU), no
JAX prove: every inner proof comes from the port and is carried to the JAX
classes through its VK and proof JSON.

- The four cases of the JAX package's tests/test_recursion.py: the
  Fibonacci chain of tests/test_e2e.py (plain), the xor4 lookup circuit
  with PoW 4 (specialized lookups), the general-purpose-column lookup
  circuit of tests/test_lookup_general.py, and the Fibonacci chain under
  the legacy Poseidon transcript. For each, the inner assemblies are equal;
  `circuits.recursion`, one circuit function over each package's classes,
  builds identical outer assemblies word for word (tolerance 0: exact field
  elements) whose public inputs are the inner proof's; the port's
  satisfiability check accepts the honest proof and rejects each tampered
  one (a public input, a lookup sum at 0, the PoW nonce, a lookup
  opening at z; and on the plain proof a cap, the quotient's opening at
  z, a Merkle sibling, a FRI leaf and a final monomial: the transcript,
  the quotient identity, the paths, the folds and the last check).
- The plain recursion circuit at 2^10 rows, proved by the port on the CPU:
  its verifier and the JAX package's verifier both accept the proof, whose
  public input is the inner proof's.
The two lookup circuits (2^9 rows, their tables') and the outer circuit are
proved at LDE 2, the quotient at its own degree (4 and 8), where the JAX
tests take LDE 8: a quarter of the plain Poseidon2 hashing on the CPU, the
same branches of the verifier.
"""

import dataclasses
import functools
from types import SimpleNamespace

import pytest

from boojum_tpu import serialization as jser
from boojum_tpu.cs.gates.simple import PublicInputGate as JPublicInputGate
from boojum_tpu.cs.implementations import ConstraintSystem as JConstraintSystem
from boojum_tpu.cs.types import CSGeometry as JCSGeometry
from boojum_tpu.gadgets.recursion import recursive_verify as jrecursive_verify
from boojum_tpu.prover.proof import Proof as JProof
from boojum_tpu_torch import circuits
from boojum_tpu_torch.prover import ProofConfig, generate_setup, prove, verify
from boojum_tpu_torch.prover.layout import OracleLayout
from boojum_tpu_torch.prover.proof import Proof
from boojum_tpu_torch.prover.satisfiability import check_if_satisfied
from boojum_tpu_torch.serialization import vk_to_json
from torch_port_util import assert_same_assembly

P = 0xFFFFFFFF00000001
JNS = SimpleNamespace(ConstraintSystem=JConstraintSystem, CSGeometry=JCSGeometry,
                      PublicInputGate=JPublicInputGate, recursive_verify=jrecursive_verify)
TNS = circuits.port_recursion_namespace()
# the JAX tests' configs of tests/test_recursion.py and
# tests/test_lookup_general.py, at LDE 2 where the trace is 2^9 rows or more
LOOKUP_POW_CONFIG = ProofConfig(fri_lde_factor=2, merkle_tree_cap_size=4, num_queries=4,
                                pow_bits=4, fri_final_degree=4)
GENERAL_LOOKUP_CONFIG = ProofConfig(fri_lde_factor=2, merkle_tree_cap_size=4, num_queries=8,
                                    pow_bits=0, fri_final_degree=4)
OUTER_CONFIG = ProofConfig(fri_lde_factor=2, merkle_tree_cap_size=8, num_queries=4,
                           pow_bits=0, fri_final_degree=16)


def _jax_fibonacci():
    from test_e2e import build_fibonacci_circuit

    return build_fibonacci_circuit(steps=20)[0]


def _jax_xor():
    from boojum_tpu.examples import build_xor_lookup_circuit

    return build_xor_lookup_circuit(num_lookups=8)[0]


def _jax_general():
    from test_lookup_general import build_circuit

    return build_circuit(num_lookups=20)[0]


# case: (the port's inner circuit, the JAX package's, the inner config)
CASES = {
    "plain": (lambda: circuits.fibonacci(TNS)[0], _jax_fibonacci,
              circuits.recursion_inner_config()),
    "lookups with PoW": (lambda: circuits.build_xor_lookup(num_lookups=8)[0], _jax_xor,
                         LOOKUP_POW_CONFIG),
    "general lookups": (lambda: circuits.build_general_lookup()[0], _jax_general,
                        GENERAL_LOOKUP_CONFIG),
    "legacy poseidon transcript": (lambda: circuits.fibonacci(TNS)[0], _jax_fibonacci,
                                   circuits.recursion_inner_config("poseidon")),
}


@functools.lru_cache(maxsize=None)
def inner(case):
    """The port's inner proof of `case` on the CPU, and its JAX twin."""
    build, jbuild, cfg = CASES[case]
    asm, jasm = build().into_assembly(), jbuild().into_assembly()
    setup = generate_setup(asm, cfg, device="cpu")
    proof = prove(asm, setup, cfg, device="cpu")
    assert verify(setup.vk, proof, asm.gates)
    assert setup.vk.transcript == cfg.transcript
    return SimpleNamespace(asm=asm, jasm=jasm, vk=setup.vk, proof=proof,
                           jvk=jser.vk_from_json(vk_to_json(setup.vk)))


def outer(m, case, proof):
    """The recursion circuit over `proof` (the port's Proof; carried to the
    JAX classes by its JSON for JNS) in namespace m."""
    run = inner(case)
    if m is JNS:
        return circuits.recursion(m, run.jvk, [JProof.from_json(proof.to_json())],
                                  run.jasm.gates)
    return circuits.recursion(m, run.vk, [proof], run.asm.gates)


@pytest.mark.parametrize("case", sorted(CASES))
def test_inner_assembly_matches_jax(case):
    run = inner(case)
    assert_same_assembly(run.asm, run.jasm)


@pytest.mark.parametrize("case", sorted(CASES))
def test_outer_assembly_matches_jax(case):
    run = inner(case)
    tcs, jcs = outer(TNS, case, run.proof), outer(JNS, case, run.proof)
    ta, ja = tcs.into_assembly(), jcs.into_assembly()
    assert_same_assembly(ta, ja)
    assert [v for _c, _r, v in ta.public_inputs] == run.proof.public_inputs
    assert {g.name for g in ta.gates} >= {
        "poseidon_flat" if case.startswith("legacy") else "poseidon2_flat"}
    assert check_if_satisfied(ta)


def _bump(words):
    return ((words[0] + 1) % P, *words[1:])


def _tamper(case, what, proof):
    bad = Proof.from_json(proof.to_json())
    q = bad.queries[0]
    if what == "public input":
        bad.public_inputs[0] = (bad.public_inputs[0] + 1) % P
    elif what == "lookup sum at 0":
        bad.values_at_0[0] = _bump(bad.values_at_0[0])
    elif what == "PoW nonce":
        bad.pow_challenge += 1
    elif what == "witness cap":
        bad.witness_cap[0] = _bump(bad.witness_cap[0])
    elif what == "quotient opening at z":
        bad.values_at_z[-1] = _bump(bad.values_at_z[-1])
    elif what == "Merkle sibling":
        q.witness.path[0] = _bump(q.witness.path[0])
    elif what == "FRI leaf":
        q.fri[0].leaf_values[0] = (q.fri[0].leaf_values[0] + 1) % P
    elif what == "final monomial":
        bad.final_fri_monomials[0] = _bump(bad.final_fri_monomials[0])
    else:  # the first lookup A opening at z
        run = inner(case)
        lo = OracleLayout.build(run.asm.geometry, run.vk.lookup_params, run.asm.gates,
                                run.vk.selector_paths)
        at = lo.num_wit_rows + lo.num_setup_rows + lo.ab_row
        bad.values_at_z[at] = _bump(bad.values_at_z[at])
    return bad


@pytest.mark.parametrize("case,what", [
    ("plain", "public input"), ("plain", "witness cap"), ("plain", "quotient opening at z"),
    ("plain", "Merkle sibling"), ("plain", "FRI leaf"), ("plain", "final monomial"),
    ("lookups with PoW", "lookup sum at 0"),
    ("lookups with PoW", "PoW nonce"), ("general lookups", "lookup opening at z"),
    ("legacy poseidon transcript", "public input")])
def test_tampered_proof_is_unsatisfiable(case, what):
    bad = _tamper(case, what, inner(case).proof)
    assert not check_if_satisfied(outer(TNS, case, bad).into_assembly())


def test_outer_proof_is_accepted_by_both_verifiers():
    """The plain recursion circuit (2^10 rows) set up and proved by the port
    on the CPU; the port's and the JAX package's verifiers accept it."""
    from boojum_tpu.prover import verify as jverify

    run = inner("plain")
    asm = outer(TNS, "plain", run.proof).into_assembly()
    jasm = outer(JNS, "plain", run.proof).into_assembly()
    assert asm.trace_len == 1 << 10
    setup = generate_setup(asm, OUTER_CONFIG, device="cpu")
    proof = prove(asm, setup, OUTER_CONFIG, device="cpu")
    assert proof.public_inputs == run.proof.public_inputs
    assert verify(setup.vk, proof, asm.gates)
    assert jverify(jser.vk_from_json(vk_to_json(setup.vk)), JProof.from_json(proof.to_json()),
                   jasm.gates)
    bad = dataclasses.replace(proof, public_inputs=[(proof.public_inputs[0] + 1) % P])
    assert not verify(setup.vk, bad, asm.gates)

