"""boojum_tpu_torch's witness columns against boojum_tpu's on the circuit of
test_witness_columns.py (is_zero checks whose inverse lives in a witness
column, chained through FMAs: 8 copy, 4 witness and 6 constant columns), on
the CPU with the plain version of every kernel: synthesis arrays (copy and
witness placements), one coset of the quotient sweep with the gates'
witness loads, the gate-terms and copy-permutation entries of the sweep,
the setup cap, the checkpoint stream and the proof bytes, each word for
word (tolerance 0: every value is an exact field element), and each
package's verifier on the other's proof.

The JAX package proves once, in the module's jax_proof fixture; the port
proves materialized and with every commit streamed (threshold 0), and both
proofs must be the JAX proof's bytes."""

import dataclasses
import json
import math
from functools import lru_cache
from types import SimpleNamespace

import numpy as np
import pytest
from test_witness_columns import CONFIG as JCONFIG
from test_witness_columns import build_circuit as jax_build_circuit

from boojum_tpu.prover import generate_setup as jgenerate_setup
from boojum_tpu.prover import prove as jprove
from boojum_tpu.prover import verify as jverify
from boojum_tpu.prover.proof import Proof as JProof
from boojum_tpu.prover.setup import build_constant_columns as jbuild_constant_columns
from boojum_tpu.prover.setup import compute_sigma_values as jcompute_sigma_values
from boojum_tpu.utils.report import CheckpointLog as JCheckpointLog
from boojum_tpu.utils.report import install_checkpoint_log
from boojum_tpu_torch.circuits import build_zero_check_witness, small_proof_config
from boojum_tpu_torch.compat import assembly_from_arrays, setup_from_arrays
from boojum_tpu_torch.prover import generate_setup, prove, verify
from boojum_tpu_torch.prover.layout import OracleLayout
from boojum_tpu_torch.prover.proof import Proof
from boojum_tpu_torch.utils.report import CheckpointLog
from torch_port_util import P, entry_against_jax, jax_selector_paths, sweep_against_jax


@lru_cache(maxsize=1)
def jax_assembly():
    cs, out = jax_build_circuit()
    return cs.into_assembly(), cs.get_value(out)


@lru_cache(maxsize=1)
def port_assembly():
    cs, out = build_zero_check_witness()
    return cs.into_assembly(), cs.get_value(out)


@pytest.mark.parametrize("name", ["copy_placement", "copy_cols_values", "wit_placement",
                                  "wit_cols_values", "row_gate"])
def test_synthesis_arrays_match_jax(name):
    np.testing.assert_array_equal(getattr(port_assembly()[0], name),
                                  getattr(jax_assembly()[0], name))


def test_synthesis_shape_matches_jax():
    (ja, jout), (ta, tout) = jax_assembly(), port_assembly()
    assert ta.trace_len == ja.trace_len == 32
    assert [g.name for g in ta.gates] == [g.name for g in ja.gates]
    assert "zero_check_wit" in [g.name for g in ta.gates]
    assert ta.gate_constants == ja.gate_constants
    assert ta.public_inputs == [tuple(p) for p in ja.public_inputs]
    assert tout == jout == 4  # i % 3 == 0 at steps 0, 3, 6, 9
    assert ta.num_wit_cols == 4 and (ta.wit_placement >= 0).any()
    assert ta.lookup_mode == "none"


def test_witness_places_are_odd_and_valued():
    """Witness places carry the tag bit; each used cell holds 1/x of its
    instance's x, or 0 where x is 0."""
    from boojum_tpu_torch.field import gl

    ta, _ = port_assembly()
    used = ta.wit_placement >= 0
    assert (ta.wit_placement[used] & 1).all()
    for col, row in zip(*np.nonzero(used)):
        x = int(ta.copy_cols_values[2 * col, row])
        aux = int(ta.wit_cols_values[col, row])
        assert aux == (gl.inv(x) if x else 0)


def test_layout_puts_the_witness_columns_before_the_multiplicities():
    ta, _ = port_assembly()
    lo = OracleLayout.build(ta.geometry)
    assert (lo.Ct, lo.wit_col, lo.num_wit_rows, lo.num_setup_rows) == (8, 8, 12, 14)


def test_compat_converts_the_jax_assembly():
    """The JAX assembly's arrays and its numpy setup columns give the port's
    own setup cap."""
    ja, _ = jax_assembly()
    paths, ks = jax_selector_paths(ja)
    asm = assembly_from_arrays(
        geometry=dataclasses.astuple(ja.geometry), trace_len=ja.trace_len,
        gate_names=[g.name for g in ja.gates], row_gate=ja.row_gate,
        gate_constants=ja.gate_constants, copy_placement=ja.copy_placement,
        copy_values=ja.copy_cols_values, public_inputs=ja.public_inputs,
        wit_placement=ja.wit_placement, wit_values=ja.wit_cols_values,
    )
    cfg = small_proof_config()
    own = generate_setup(port_assembly()[0], cfg, device="cpu")
    setup = setup_from_arrays(
        asm, cfg, sigma_cols=jcompute_sigma_values(ja.copy_placement, ja.trace_len),
        constant_cols=jbuild_constant_columns(ja, paths), selector_paths=paths,
        non_residues=ks, quotient_degree=own.vk.quotient_degree, device="cpu")
    assert setup.vk.setup_merkle_cap == own.vk.setup_merkle_cap
    assert setup.vk.num_wit_cols == 4


@pytest.mark.parametrize("seed", [0, 1])
def test_sweep_plain_matches_jax_u64_core(seed):
    ja, _ = jax_assembly()
    paths, ks = jax_selector_paths(ja)
    sweep_against_jax(ja, SimpleNamespace(selector_paths=paths, non_residues=ks), seed, 64)


@pytest.mark.parametrize("entry", ["gate_terms_fn", "cp_quotient"])
def test_sweep_entry_matches_jax(entry):
    entry_against_jax(entry, jax_assembly()[0], 5, 64)


@pytest.fixture(scope="module")
def jax_proof():
    """The JAX package's setup, proof and checkpoint stream."""
    ja, _ = jax_assembly()
    jsetup = jgenerate_setup(ja, JCONFIG)
    log = JCheckpointLog()
    prev = install_checkpoint_log(log)
    try:
        jproof = jprove(ja, jsetup, JCONFIG)
    finally:
        install_checkpoint_log(prev)
    stream = [(e["round"], e["label"], e["digest"]) for e in log.entries]
    return jsetup, jproof, stream


@pytest.mark.parametrize("threshold", [math.inf, 0], ids=["materialized", "streamed"])
def test_prove_matches_jax(jax_proof, threshold):
    """The JAX prover's setup, checkpoint stream and proof JSON, and each
    verifier on the other's proof; a changed witness opening rejected."""
    ja, jout = jax_assembly()
    jsetup, jproof, stream = jax_proof
    asm, _ = port_assembly()
    setup = generate_setup(asm, small_proof_config(), device="cpu",
                           stream_threshold_bytes=threshold)
    assert (setup.setup_lde is None) == (threshold == 0)
    tlog = CheckpointLog()
    proof = prove(asm, setup, small_proof_config(), device="cpu", log=tlog,
                  stream_threshold_bytes=threshold)
    assert setup.vk.setup_merkle_cap == jsetup.vk.setup_merkle_cap
    assert json.dumps(setup.vk.to_dict()) == json.dumps(jsetup.vk.to_dict())
    assert [s[:2] for s in tlog.stream()] == [s[:2] for s in stream]
    assert tlog.stream() == stream
    assert proof.to_json() == jproof.to_json()
    assert proof.public_inputs == [jout]
    assert verify(setup.vk, proof, asm.gates)
    assert jverify(jsetup.vk, JProof.from_json(proof.to_json()), ja.gates)
    assert verify(setup.vk, Proof.from_json(jproof.to_json()), asm.gates)
    for where in ("witness_opening", "witness_value_at_z"):
        bad = _tampered(proof, where)
        assert not verify(setup.vk, Proof.from_json(bad), asm.gates), where
    assert not jverify(jsetup.vk, JProof.from_json(_tampered(proof, "witness_opening")),
                       ja.gates)


def _tampered(proof, where):
    """A witness column's value (column 8, the first after the copy
    columns) changed in one query's leaf, or at z."""
    d = json.loads(proof.to_json())
    if where == "witness_opening":
        d["queries"][0]["witness"]["leaf_values"][8] += 1
    else:
        d["values_at_z"][8][0] = (d["values_at_z"][8][0] + 1) % P
    return json.dumps(d)
