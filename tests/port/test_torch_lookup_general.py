"""boojum_tpu_torch's general-purpose-column lookups against boojum_tpu's on
the circuit of test_lookup_general.py (xor4 lookups and 4-bit range checks
on lookup-marker rows of 8 general copy columns, width 3, so 8 // 3 = 2
sub-arguments; 2^9 rows), on the CPU with the plain version of every
kernel: synthesis arrays, the stage-2 lookup polynomials, one coset of the
quotient sweep and its two lookup entries, the setup cap, the checkpoint
stream and the proof bytes, each word for word (tolerance 0: every value is
an exact field element), and each package's verifier on the other's proof.

The JAX package proves once, in the module's jax_proof fixture; the port
proves materialized and with every commit streamed (threshold 0), and both
proofs must be the JAX proof's bytes."""

import dataclasses
import json
import math
from functools import lru_cache
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_lookup_general import CONFIG as JCONFIG
from test_lookup_general import build_circuit as jax_build_circuit

from boojum_tpu.prover import generate_setup as jgenerate_setup
from boojum_tpu.prover import prove as jprove
from boojum_tpu.prover import stages as jstages
from boojum_tpu.prover import verify as jverify
from boojum_tpu.prover.proof import Proof as JProof
from boojum_tpu.utils.report import CheckpointLog as JCheckpointLog
from boojum_tpu.utils.report import install_checkpoint_log
from boojum_tpu_torch.circuits import build_general_lookup, small_proof_config
from boojum_tpu_torch.compat import assembly_from_arrays
from boojum_tpu_torch.prover import generate_setup, prove, stages, verify
from boojum_tpu_torch.prover.proof import Proof
from boojum_tpu_torch.prover.quotient_sweep import selector_from_consts
from boojum_tpu_torch.utils.report import CheckpointLog
from torch_port_util import (
    P, entry_against_jax, jax_selector_paths, rand_words, sweep_against_jax, to_np, to_t,
)


@lru_cache(maxsize=1)
def jax_assembly():
    cs, acc = jax_build_circuit()
    return cs.into_assembly(), cs.get_value(acc)


@lru_cache(maxsize=1)
def port_assembly():
    cs, acc = build_general_lookup()
    return cs.into_assembly(), cs.get_value(acc)


def test_config_is_the_jax_test_config():
    port = dataclasses.asdict(small_proof_config())
    assert port == {k: getattr(JCONFIG, k) for k in port}


@pytest.mark.parametrize("name", ["copy_placement", "copy_cols_values", "multiplicities",
                                  "row_gate"])
def test_synthesis_arrays_match_jax(name):
    np.testing.assert_array_equal(getattr(port_assembly()[0], name),
                                  getattr(jax_assembly()[0], name))


def test_synthesis_shape_matches_jax():
    (ja, jacc), (ta, tacc) = jax_assembly(), port_assembly()
    assert ta.trace_len == ja.trace_len == 1 << 9
    assert [g.name for g in ta.gates] == [g.name for g in ja.gates] == [
        "lookup_marker", "constant", "fma", "public_input", "nop"]
    assert ta.gate_constants == ja.gate_constants
    assert ta.public_inputs == [tuple(p) for p in ja.public_inputs]
    assert tacc == jacc
    assert (ta.lookup_mode, ta.num_lookup_subargs, ta.num_lookup_cols,
            ta.lookup_marker_gid()) == (ja.lookup_mode, ja.num_lookup_subargs,
                                        ja.num_lookup_cols, ja.lookup_marker_gid()) == (
        "general", 2, 0, 0)
    assert ta.lookup_table_id_col is None
    np.testing.assert_array_equal(ta.stacked_table_columns(3), ja.stacked_table_columns(3))


def test_marker_padding_counts_row_0():
    """Every vacant marker instance takes table row 0 and counts it: the
    multiplicities sum to the marker instances, each row holding two."""
    ta, _ = port_assembly()
    markers = int((ta.row_gate == ta.lookup_marker_gid()).sum())
    assert int(ta.multiplicities.sum()) == 2 * markers == 2 * 20


def test_compat_converts_the_jax_assembly():
    ja, _ = jax_assembly()
    lp = ja.lookup_params
    asm = assembly_from_arrays(
        geometry=(8, 0, 6, 4), trace_len=ja.trace_len,
        gate_names=[g.name for g in ja.gates], row_gate=ja.row_gate,
        gate_constants=ja.gate_constants, copy_placement=ja.copy_placement,
        copy_values=ja.copy_cols_values, public_inputs=ja.public_inputs,
        lookup_params=(lp.width, lp.num_repetitions, lp.share_table_id,
                       lp.use_specialized_columns),
        multiplicities=ja.multiplicities, table_stack=ja.stacked_table_columns(lp.width),
    )
    assert (asm.lookup_mode, asm.num_lookup_subargs, asm.gates[0].principal_width) == (
        "general", 2, 3)
    np.testing.assert_array_equal(asm.multiplicities, port_assembly()[0].multiplicities)


@pytest.mark.parametrize("seed", [0, 1])
def test_stage2_lookup_polys_match_jax(seed):
    """A_i = sel/den_i and B over H from the assembly's columns and random
    challenges, against stages.py compute_lookup_polys_general."""
    ja, _ = jax_assembly()
    paths, _ks = jax_selector_paths(ja)
    from boojum_tpu.prover.setup import build_constant_columns

    consts = build_constant_columns(ja, paths)
    mk_path = paths[ja.lookup_marker_gid()]
    rng = np.random.default_rng(seed)
    lbeta, lgamma = (tuple(int(v) for v in rand_words(rng, 2)) for _ in range(2))
    tables = ja.stacked_table_columns(3)
    sel = selector_from_consts(to_t(consts), mk_path)
    with jax.disable_jit():
        want_a, want_b = jstages.compute_lookup_polys_general(
            jnp.asarray(ja.copy_cols_values[:6]), jnp.asarray(consts[len(mk_path)]),
            jnp.asarray(tables), jnp.asarray(ja.multiplicities), jnp.asarray(to_np(sel)),
            lbeta, lgamma, 2, 3)
    got_a, got_b = stages.compute_lookup_polys_general(
        to_t(ja.copy_cols_values[:6]), to_t(consts[len(mk_path)]), to_t(tables),
        to_t(ja.multiplicities), sel, lbeta, lgamma, 2, 3)
    for g, w in zip([*got_a, got_b], [*want_a, want_b]):
        for gc, wc in zip(g, w):
            np.testing.assert_array_equal(to_np(gc), np.asarray(wc))


def test_bad_tuple_unbalances_the_lookup_sums():
    """Σ_i Σ_H A_i = Σ_H B holds for the assembly and fails once one tuple
    leaves its table: the sum check the verifier makes at 0."""
    from boojum_tpu_torch.field import goldilocks as gf
    from boojum_tpu_torch.prover.setup import build_constant_columns, build_selector_tree

    ta, _ = port_assembly()
    _tree, paths = build_selector_tree(ta.gates)
    consts = to_t(build_constant_columns(ta, paths))
    mk_path = paths[ta.lookup_marker_gid()]
    sel = selector_from_consts(consts, mk_path)
    tables = to_t(ta.stacked_table_columns(3))

    def balanced(cols):
        a_polys, b_poly = stages.compute_lookup_polys_general(
            to_t(cols[:6]), consts[len(mk_path)], tables, to_t(ta.multiplicities), sel,
            (3, 5), (7, 11), 2, 3)
        a_sum = [int(gf.modsum(torch.cat([a[c] for a in a_polys]))) for c in (0, 1)]
        return a_sum == [int(gf.modsum(b_poly[c])) for c in (0, 1)]

    assert balanced(ta.copy_cols_values)
    bad = ta.copy_cols_values.copy()
    bad[0, np.nonzero(ta.row_gate == ta.lookup_marker_gid())[0][0]] = 17  # off the table
    assert not balanced(bad)


@pytest.mark.parametrize("seed", [0, 1])
def test_sweep_plain_matches_jax_u64_core(seed):
    ja, _ = jax_assembly()
    paths, ks = jax_selector_paths(ja)
    sweep_against_jax(ja, SimpleNamespace(selector_paths=paths, non_residues=ks), seed, 64)


@pytest.mark.parametrize("entry", ["lookup_quotient", "lookup_quotient_general"])
def test_lookup_entry_matches_jax(entry):
    entry_against_jax(entry, jax_assembly()[0], 3, 64)


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
    verifier on the other's proof; tampered openings rejected."""
    ja, jacc = jax_assembly()
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
    assert proof.public_inputs == [jacc] and len(proof.values_at_0) == 3
    assert verify(setup.vk, proof, asm.gates)
    assert jverify(jsetup.vk, JProof.from_json(proof.to_json()), ja.gates)
    assert verify(setup.vk, Proof.from_json(jproof.to_json()), asm.gates)
    for where in ("value_at_0", "multiplicity_opening", "tuple_opening",
                  "lookup_value_at_z"):
        bad = _tampered(proof, where)
        assert not verify(setup.vk, Proof.from_json(bad), asm.gates), where
    assert not jverify(jsetup.vk, JProof.from_json(_tampered(proof, "value_at_0")), ja.gates)


def _tampered(proof, where):
    d = json.loads(proof.to_json())
    if where == "value_at_0":
        d["values_at_0"][0][0] = (d["values_at_0"][0][0] + 1) % P
    elif where == "multiplicity_opening":
        d["queries"][0]["witness"]["leaf_values"][-1] += 1
    elif where == "tuple_opening":
        d["queries"][0]["witness"]["leaf_values"][0] += 1
    else:  # A_0's c1 at z: stage 2 ends [A_0, A_1, B] before the quotient
        i = -2 * d["config"]["quotient_degree"] - 5
        d["values_at_z"][i][1] = (d["values_at_z"][i][1] + 1) % P
    return json.dumps(d)
