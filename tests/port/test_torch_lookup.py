"""boojum_tpu_torch's specialized-column lookups against boojum_tpu's on the
xor4 lookup circuit of examples.py (the configuration of test_lookup.py) at
2^9 rows, on the CPU with the plain version of every kernel: synthesis
arrays, setup, the stage-2 lookup polynomials, one coset of the quotient
sweep, the checkpoint stream and the proof bytes, each word for word
(tolerance 0: every value is an exact field element), and each package's
verifier on the other's proof."""

import dataclasses
import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

from boojum_tpu.cs.types import CSGeometry as JCSGeometry
from boojum_tpu.cs.types import LookupParameters as JLookupParameters
from boojum_tpu.examples import build_xor_lookup_circuit
from boojum_tpu.prover import ProofConfig as JProofConfig
from boojum_tpu.prover import generate_setup as jgenerate_setup
from boojum_tpu.prover import prove as jprove
from boojum_tpu.prover import verify as jverify
from boojum_tpu.prover import stages as jstages
from boojum_tpu.prover.proof import Proof as JProof
from boojum_tpu.utils.report import CheckpointLog as JCheckpointLog
from boojum_tpu.utils.report import install_checkpoint_log
from boojum_tpu_torch.circuits import build_xor_lookup, xor_lookup_proof_config
from boojum_tpu_torch.compat import assembly_from_arrays, setup_from_arrays
from boojum_tpu_torch.prover import generate_setup, prove, verify
from boojum_tpu_torch.prover import stages
from boojum_tpu_torch.prover.proof import Proof
from boojum_tpu_torch.utils.report import CheckpointLog
from torch_port_util import P, rand_words, sweep_against_jax, to_np, to_t

GEOMETRY = JCSGeometry(8, 0, 6, 4)
LOOKUP = JLookupParameters(width=3, num_repetitions=2)
CONFIG = dict(fri_lde_factor=8, merkle_tree_cap_size=4, num_queries=20,
              pow_bits=0, fri_final_degree=4)


@pytest.fixture(scope="module")
def jax_run():
    cs, _acc, _out = build_xor_lookup_circuit(30, geometry=GEOMETRY, lookup_params=LOOKUP)
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
def port_run():
    cs, _acc, _out = build_xor_lookup()
    asm = cs.into_assembly()
    cfg = xor_lookup_proof_config()
    setup = generate_setup(asm, cfg, device="cpu")
    log = CheckpointLog()
    proof = prove(asm, setup, cfg, device="cpu", log=log)
    return SimpleNamespace(asm=asm, setup=setup, proof=proof, stream=log.stream())


def test_config_is_the_jax_test_config():
    assert dataclasses.asdict(xor_lookup_proof_config()) == dataclasses.asdict(
        JProofConfig(**CONFIG))


ARRAYS = ("copy_placement", "copy_cols_values", "lookup_placement",
          "lookup_cols_values", "lookup_table_id_col", "multiplicities", "row_gate")


@pytest.mark.parametrize("name", ARRAYS)
def test_synthesis_arrays_match_jax(jax_run, port_run, name):
    np.testing.assert_array_equal(getattr(port_run.asm, name), getattr(jax_run.asm, name))


def test_synthesis_shape_matches_jax(jax_run, port_run):
    ja, ta = jax_run.asm, port_run.asm
    assert ta.trace_len == ja.trace_len == 1 << 9
    assert [g.name for g in ta.gates] == [g.name for g in ja.gates] == [
        "constant", "fma", "public_input", "nop"]
    assert ta.gate_constants == ja.gate_constants
    assert ta.public_inputs == [tuple(p) for p in ja.public_inputs]
    assert (ta.lookup_mode, ta.num_lookup_subargs, ta.num_lookup_cols) == (
        ja.lookup_mode, ja.num_lookup_subargs, ja.num_lookup_cols) == ("specialized", 2, 6)
    np.testing.assert_array_equal(ta.stacked_table_columns(3), ja.stacked_table_columns(3))


def test_setup_matches_jax(jax_run, port_run):
    js, ts = jax_run.setup, port_run.setup
    np.testing.assert_array_equal(ts.sigma_cols, js.sigma_cols)
    np.testing.assert_array_equal(ts.constant_cols, js.constant_cols)
    np.testing.assert_array_equal(to_np(ts.setup_monomials), np.asarray(js.setup_monomials))
    assert ts.vk.setup_merkle_cap == js.vk.setup_merkle_cap
    assert json.dumps(ts.vk.to_dict()) == json.dumps(js.vk.to_dict())


def _compat_assembly(ja):
    lp = ja.lookup_params
    return assembly_from_arrays(
        geometry=dataclasses.astuple(ja.geometry),
        trace_len=ja.trace_len,
        gate_names=[g.name for g in ja.gates],
        row_gate=ja.row_gate,
        gate_constants=ja.gate_constants,
        copy_placement=ja.copy_placement,
        copy_values=ja.copy_cols_values,
        public_inputs=ja.public_inputs,
        lookup_params=(lp.width, lp.num_repetitions, lp.share_table_id,
                       lp.use_specialized_columns),
        lookup_placement=ja.lookup_placement,
        lookup_values=ja.lookup_cols_values,
        multiplicities=ja.multiplicities,
        table_id_col=ja.lookup_table_id_col,
        table_stack=ja.stacked_table_columns(lp.width),
    )


def test_compat_reproduces_setup_cap(jax_run):
    ja, js = jax_run.asm, jax_run.setup
    asm = _compat_assembly(ja)
    assert asm.num_lookup_tables == len(ja.lookup_tables)
    setup = setup_from_arrays(
        asm, xor_lookup_proof_config(), sigma_cols=js.sigma_cols,
        constant_cols=js.constant_cols, selector_paths=js.selector_paths,
        non_residues=js.non_residues, quotient_degree=js.vk.quotient_degree,
        device="cpu",
    )
    assert setup.vk.setup_merkle_cap == js.vk.setup_merkle_cap


@pytest.mark.parametrize("seed", [0, 1])
def test_stage2_lookup_polys_match_jax(jax_run, seed):
    """A_i and B over H from the assembly's columns and random challenges,
    against stages.py compute_lookup_polys."""
    ja, js = jax_run.asm, jax_run.setup
    rng = np.random.default_rng(seed)
    lbeta, lgamma = (tuple(int(v) for v in rand_words(rng, 2)) for _ in range(2))
    tables = ja.stacked_table_columns(3)
    want_a, want_b = jstages.compute_lookup_polys(
        jnp.asarray(ja.lookup_cols_values), jnp.asarray(js.constant_cols[-1]),
        jnp.asarray(tables), jnp.asarray(ja.multiplicities), lbeta, lgamma, 2, 3)
    got_a, got_b = stages.compute_lookup_polys(
        to_t(ja.lookup_cols_values), to_t(js.constant_cols[-1]), to_t(tables),
        to_t(ja.multiplicities), lbeta, lgamma, 2, 3)
    for g, w in zip([*got_a, got_b], [*want_a, want_b]):
        for gc, wc in zip(g, w):
            np.testing.assert_array_equal(to_np(gc), np.asarray(wc))


@pytest.mark.parametrize("seed", [0, 1])
def test_sweep_plain_matches_jax_u64_core(jax_run, seed):
    sweep_against_jax(jax_run.asm, jax_run.setup, seed, 64)


def test_checkpoint_stream_matches_jax(jax_run, port_run):
    assert [s[:2] for s in port_run.stream] == [s[:2] for s in jax_run.stream]
    assert port_run.stream == jax_run.stream


def test_proof_bytes_match_jax(jax_run, port_run):
    assert port_run.proof.to_json() == jax_run.proof.to_json()
    assert len(port_run.proof.values_at_0) == 3


def test_port_verifier_accepts(port_run):
    assert verify(port_run.setup.vk, port_run.proof, port_run.asm.gates)


def test_jax_verifier_accepts_port_proof(jax_run, port_run):
    assert jverify(jax_run.setup.vk, JProof.from_json(port_run.proof.to_json()),
                   jax_run.asm.gates)


def test_port_verifier_accepts_jax_proof(jax_run, port_run):
    assert verify(port_run.setup.vk, Proof.from_json(jax_run.proof.to_json()),
                  port_run.asm.gates)


def _tampered(proof, where):
    d = json.loads(proof.to_json())
    if where == "value_at_0":
        d["values_at_0"][0][0] = (d["values_at_0"][0][0] + 1) % P
    elif where == "multiplicity_opening":
        d["queries"][0]["witness"]["leaf_values"][-1] += 1
    elif where == "lookup_value_at_z":
        # A_0's c1 column at z: stage 2 ends [A_0, A_1, B] before the quotient
        i = -2 * d["config"]["quotient_degree"] - 5
        d["values_at_z"][i][1] = (d["values_at_z"][i][1] + 1) % P
    else:
        d["values_at_z"][14][0] = (d["values_at_z"][14][0] + 1) % P  # multiplicities
    return json.dumps(d)


@pytest.mark.parametrize("where", ["value_at_0", "multiplicity_opening",
                                   "lookup_value_at_z", "multiplicity_at_z"])
def test_port_verifier_rejects_tampering(port_run, where):
    bad = Proof.from_json(_tampered(port_run.proof, where))
    assert not verify(port_run.setup.vk, bad, port_run.asm.gates)


def test_jax_verifier_rejects_changed_value_at_0(jax_run, port_run):
    bad = JProof.from_json(_tampered(port_run.proof, "value_at_0"))
    assert not jverify(jax_run.setup.vk, bad, jax_run.asm.gates)
