"""boojum_tpu_torch's BabyBear prover against boojum_tpu's on the CPU.

The fma chain (bench.py's build_fma at 2^10) and the xor4 lookup circuit
(600 lookups, 2^10 rows), synthesized over BabyBear by both packages and
proved with the config of the JAX package's tests/test_bb_full_prover.py:
the assemblies, the setup cap, the checkpoint stream and the proof's JSON
text equal the JAX package's numpy reference prover's
(compat/prove_reference_bb.py prove_full_babybear_reference, which that
package's own tests pin byte for byte to its device prover). The quotient
identity at z holds on the port's proof and fails on a corrupted one, and
every opened path checks against its cap. The mini-STARK at 2^10 is the JAX
reference's proof, and its verifier accepts it and rejects a corrupted one.
"""

import copy
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from boojum_tpu.compat.prove_reference_bb import (
    prove_babybear_reference,
    prove_full_babybear_reference,
)
from boojum_tpu.examples import build_xor_lookup_circuit
from boojum_tpu.prover import ProofConfig as JProofConfig
from boojum_tpu.prover import generate_setup as jgenerate_setup
from boojum_tpu.prover.bb_prover import BBProofConfig as JBBProofConfig
from boojum_tpu.utils.report import CheckpointLog as JCheckpointLog
from boojum_tpu.utils.report import install_checkpoint_log
from boojum_tpu_torch.circuits import build_fma, build_xor_lookup
from boojum_tpu_torch.prover import ProofConfig, generate_setup, prove, verify
from boojum_tpu_torch.prover.bb_kernels import verify_path_bb
from boojum_tpu_torch.prover.bb_prover import BBProofConfig, prove_babybear
from boojum_tpu_torch.prover.bb_verifier import check_babybear, verify_babybear
from boojum_tpu_torch.prover.prover_bb import query_paths_hold, quotient_identity_at_z
from boojum_tpu_torch.utils.report import CheckpointLog
from torch_port_util import bench_function

CONFIG = dict(fri_lde_factor=2, num_queries=8, fri_final_degree=8)
KINDS = ["fma", "xor4"]


def _jax_checkpointed(fn, *args):
    log = JCheckpointLog()
    prev = install_checkpoint_log(log)
    try:
        out = fn(*args)
    finally:
        install_checkpoint_log(prev)
    return out, [(e["round"], e["label"], e["digest"]) for e in log.entries]


@pytest.fixture(scope="module", params=KINDS)
def run(request):
    """Both packages' synthesis, setup and proof of one circuit."""
    kind = request.param
    with pytest.MonkeyPatch.context() as mp:
        # the JAX package reads the field at synthesis, setup and prove
        mp.setenv("BOOJUM_TPU_FIELD", "babybear")
        if kind == "fma":
            jasm = bench_function("build_fma")(10).into_assembly()
        else:
            jasm = build_xor_lookup_circuit(num_lookups=600, capacity=1 << 11)[0].into_assembly()
        jsetup = jgenerate_setup(jasm, JProofConfig(**CONFIG))
        jproof, jstream = _jax_checkpointed(prove_full_babybear_reference, jasm, jsetup,
                                            JProofConfig(**CONFIG))
    if kind == "fma":
        asm = build_fma(10, field="babybear").into_assembly()
    else:
        asm = build_xor_lookup(600, 1 << 11, field="babybear")[0].into_assembly()
    cfg = ProofConfig(**CONFIG)
    setup = generate_setup(asm, cfg, device="cpu")
    log = CheckpointLog()
    proof = prove(asm, setup, cfg, device="cpu", log=log)
    return SimpleNamespace(kind=kind, jasm=jasm, jsetup=jsetup, jproof=jproof,
                           jstream=jstream, asm=asm, setup=setup, proof=proof,
                           stream=log.stream())


def test_assembly_matches_jax(run):
    a, j = run.asm, run.jasm
    assert a.field == j.field == "babybear"
    assert a.trace_len == j.trace_len == 1 << 10
    np.testing.assert_array_equal(a.copy_cols_values, j.copy_cols_values)
    np.testing.assert_array_equal(a.lookup_cols_values, j.lookup_cols_values)
    assert a.public_inputs == j.public_inputs
    assert [g.name for g in a.gates] == [g.name for g in j.gates]


def test_setup_matches_jax(run):
    s, j = run.setup, run.jsetup
    assert s.vk.transcript == j.vk.transcript == "poseidon2_babybear"
    assert s.vk.quotient_degree == j.vk.effective_quotient_degree()
    np.testing.assert_array_equal(s.sigma_cols, j.sigma_cols)
    np.testing.assert_array_equal(s.constant_cols, j.constant_cols)
    assert s.non_residues == list(j.non_residues)
    assert s.vk.setup_merkle_cap == j.vk.setup_merkle_cap


def test_checkpoint_stream_matches_jax(run):
    assert len(run.stream) == len(run.jstream) > 20
    for got, want in zip(run.stream, run.jstream):
        assert got == want, f"first divergence at {want[:2]}"


def test_proof_bytes_match_jax(run):
    assert run.proof.to_json() == run.jproof.to_json()
    assert run.proof.config["field"] == "babybear"


def test_quotient_identity_holds_and_catches_a_corruption(run):
    assert quotient_identity_at_z(run.asm, run.setup, run.proof)
    bad = copy.deepcopy(run.proof)
    v = bad.values_at_z[0]
    bad.values_at_z[0] = ((v[0] + 1) % (2**31 - 2**27 + 1),) + tuple(v[1:])
    assert not quotient_identity_at_z(run.asm, run.setup, bad)


def test_every_opened_path_checks_against_its_cap(run):
    assert query_paths_hold(run.asm, run.setup, run.proof)
    bad = copy.deepcopy(run.proof)
    oq = bad.queries[3].stage2
    oq.leaf_values[5] = (oq.leaf_values[5] + 1) % (2**31 - 2**27 + 1)
    assert not query_paths_hold(run.asm, run.setup, bad)
    bad = copy.deepcopy(run.proof)
    bad.queries[1].fri[0].path[0] = (0,) * 8
    assert not query_paths_hold(run.asm, run.setup, bad)
    oq = run.proof.queries[0].witness
    assert not verify_path_bb(oq.leaf_values, oq.path, run.proof.witness_cap, 1 << 20)


def test_verify_refuses_a_babybear_key(run):
    with pytest.raises(ValueError, match="poseidon2_babybear"):
        verify(run.setup.vk, run.proof, run.asm.gates)


def test_prove_on_the_card_without_one_raises(run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prove(run.asm, run.setup, ProofConfig(**CONFIG))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_setup(run.asm, ProofConfig(**CONFIG))


@pytest.fixture(scope="module")
def mini():
    jproof, jstream = _jax_checkpointed(prove_babybear_reference, 12345,
                                        JBBProofConfig(log_n=10))
    log = CheckpointLog()
    proof = prove_babybear(12345, BBProofConfig(log_n=10), device="cpu", log=log)
    return SimpleNamespace(jproof=jproof, jstream=jstream, proof=proof, stream=log.stream())


def test_mini_stark_matches_jax(mini):
    assert mini.stream == mini.jstream
    assert dataclasses.astuple(mini.proof.config) == dataclasses.astuple(mini.jproof.config)
    for f in dataclasses.fields(mini.proof):
        if f.name != "config":
            assert getattr(mini.proof, f.name) == getattr(mini.jproof, f.name), f.name


def test_mini_stark_verifies_and_rejects_corruptions(mini):
    assert check_babybear(mini.proof) == (True, "ok")
    bad = copy.deepcopy(mini.proof)
    bad.evals["wz"] = tuple((c + 1) % (2**31 - 2**27 + 1) for c in bad.evals["wz"])
    assert not verify_babybear(bad)
    bad = copy.deepcopy(mini.proof)
    vals, path = bad.queries[0]["fri"][2]
    bad.queries[0]["fri"][2] = ([vals[0] ^ 1] + vals[1:], path)
    assert check_babybear(bad) == (False, "fri path")
    bad = copy.deepcopy(mini.proof)
    bad.final_codeword[3] = (1, 2, 3, 4)
    assert not verify_babybear(bad)
