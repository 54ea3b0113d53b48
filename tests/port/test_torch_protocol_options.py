"""The protocol options of boojum_tpu_torch against boojum_tpu's (CPU):
transcript kinds, an explicit FRI folding schedule, an explicit quotient
degree, the proof-of-work runners and the artifacts (VK JSON, setup .npz)
and one-shot drivers.

- Every transcript kind of the JAX package (transcript.TRANSCRIPTS): the
  same challenges from the same absorbs; the legacy Poseidon permutation
  and sponge; the blake2s and keccak256 proof-of-work nonces.
- tests/test_rate_decoupling.py's fma circuit (2^8 rows) at LDE 2, set up
  and proved by both packages under the blake2s transcript, the poseidon
  one with the schedule [4, 1] (an entry above the fold kernel's three
  rounds a launch) and the keccak256 one with quotient_degree=16 (16 cosets
  against 2 committed); over BabyBear the fma chain at 2^10 under
  blake2s_babybear:
  the VK JSON, the checkpoint stream and the proof JSON are the JAX
  package's, byte for byte; each Goldilocks verifier accepts the other's
  proof, and a key naming another transcript rejects it.
- A VK through serialization's JSON (either package's text) and a setup
  through its .npz give the same key and the same proof; an unknown
  transcript kind, a schedule that does not fold to the final degree and a
  quotient degree below the constraints' are refused.
"""

import dataclasses
import random
from types import SimpleNamespace

import numpy as np
import pytest

from boojum_tpu import transcript as jtranscript
from boojum_tpu.hashes import poseidon as jposeidon
from boojum_tpu.prover import ProofConfig as JProofConfig
from boojum_tpu.prover import generate_setup as jgenerate_setup
from boojum_tpu.prover import pow as jpow
from boojum_tpu.prover import prove as jprove
from boojum_tpu.prover import verify as jverify
from boojum_tpu.prover.proof import Proof as JProof
from boojum_tpu.serialization import vk_from_json as jvk_from_json
from boojum_tpu.serialization import vk_to_json as jvk_to_json
from boojum_tpu.utils.report import CheckpointLog as JCheckpointLog
from boojum_tpu.utils.report import install_checkpoint_log
from boojum_tpu_torch import serialization, transcript
from boojum_tpu_torch.circuits import build_fma
from boojum_tpu_torch.cs.gates import FmaGate, PublicInputGate
from boojum_tpu_torch.cs.implementations import ConstraintSystem
from boojum_tpu_torch.cs.types import CSGeometry
from boojum_tpu_torch.field import goldilocks as gf
from boojum_tpu_torch.hashes import poseidon
from boojum_tpu_torch.prover import (
    ProofConfig, generate_setup, prepare_setup_and_vk, pow, prove, prove_from_precomputations,
    prove_one_shot, verify, verify_circuit,
)
from boojum_tpu_torch.prover.prover_bb import query_paths_hold, quotient_identity_at_z
from boojum_tpu_torch.utils.report import CheckpointLog
from test_rate_decoupling import _fma_circuit as jfma_circuit
from torch_port_util import bench_function

P = 0xFFFFFFFF00000001


def fma_circuit():
    """tests/test_rate_decoupling.py's _fma_circuit over this package."""
    cs = ConstraintSystem(CSGeometry(8, 0, 6, 4), 1 << 10)
    x = cs.alloc_variable_with_value(3)
    y = cs.alloc_variable_with_value(4)
    for _ in range(300):
        x, y = y, FmaGate.fma(cs, x, y, x, 1, 1)
    PublicInputGate.place(cs, y)
    return cs


BASE = dict(fri_lde_factor=2, num_queries=8, fri_final_degree=8)
# each JAX prove traces its graphs anew (most of a case's time), so the
# options share cases: every transcript kind, the schedule and Q = 16
CASES = {
    "blake2s": dict(transcript="blake2s"),
    "poseidon, schedule 4,1": dict(transcript="poseidon", fri_folding_schedule=[4, 1]),
    "keccak256, quotient 16": dict(transcript="keccak256", quotient_degree=16),
    "blake2s_babybear": dict(transcript="blake2s"),
}


def _jax_checkpointed(fn, *args):
    log = JCheckpointLog()
    prev = install_checkpoint_log(log)
    try:
        out = fn(*args)
    finally:
        install_checkpoint_log(prev)
    return out, [(e["round"], e["label"], e["digest"]) for e in log.entries]


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """Both packages' setup and proof of the case's circuit and config."""
    name = request.param
    cfg = dict(BASE, **CASES[name])
    babybear = name.endswith("babybear")
    with pytest.MonkeyPatch.context() as mp:
        if babybear:
            from boojum_tpu.compat.prove_reference_bb import prove_full_babybear_reference

            mp.setenv("BOOJUM_TPU_FIELD", "babybear")
            jasm = bench_function("build_fma")(10).into_assembly()
            jprove_fn = prove_full_babybear_reference
        else:
            jasm = jfma_circuit().into_assembly()
            jprove_fn = jprove
        jsetup = jgenerate_setup(jasm, JProofConfig(**cfg))
        jproof, jstream = _jax_checkpointed(jprove_fn, jasm, jsetup, JProofConfig(**cfg))
    asm = (build_fma(10, field="babybear") if babybear else fma_circuit()).into_assembly()
    setup = generate_setup(asm, ProofConfig(**cfg), device="cpu")
    log = CheckpointLog()
    proof = prove(asm, setup, ProofConfig(**cfg), device="cpu", log=log)
    return SimpleNamespace(name=name, cfg=cfg, babybear=babybear, jasm=jasm, jsetup=jsetup,
                           jproof=jproof, jstream=jstream, asm=asm, setup=setup, proof=proof,
                           stream=log.stream())


def test_vk_stream_and_proof_match_jax(case):
    assert serialization.vk_to_json(case.setup.vk) == jvk_to_json(case.jsetup.vk)
    assert case.stream == case.jstream
    assert case.proof.to_json() == case.jproof.to_json()
    vk = case.setup.vk
    assert vk.transcript.startswith(case.cfg["transcript"])
    if "quotient_degree" in case.cfg:
        assert vk.quotient_degree == 16 and vk.fri_lde_factor == 2
        assert len(case.proof.queries[0].quotient.leaf_values) == 2 * 16
    if "fri_folding_schedule" in case.cfg:
        assert vk.fri_folding_schedule == [4, 1]
        assert [len(q.leaf_values) for q in case.proof.queries[0].fri] == [2 << 4, 2 << 1]


def test_verifiers_accept_and_a_wrong_transcript_rejects(case):
    if case.babybear:  # the JAX package has no verifier of full BabyBear proofs
        assert quotient_identity_at_z(case.asm, case.setup, case.proof)
        assert query_paths_hold(case.asm, case.setup, case.proof)
        return
    assert verify(case.setup.vk, case.proof, case.asm.gates)
    assert jverify(case.jsetup.vk, JProof.from_json(case.proof.to_json()), case.jasm.gates)
    wrong = "blake2s" if case.setup.vk.transcript == "poseidon2" else "poseidon2"
    assert not verify(dataclasses.replace(case.setup.vk, transcript=wrong), case.proof,
                      case.asm.gates)


def test_vk_json_round_trips_through_either_package(case):
    vk = case.setup.vk
    text = serialization.vk_to_json(vk)
    assert serialization.vk_from_json(text).to_dict() == vk.to_dict()
    assert jvk_from_json(text).to_dict() == vk.to_dict()
    assert serialization.vk_from_json(jvk_to_json(case.jsetup.vk)).to_dict() == vk.to_dict()
    with pytest.raises(ValueError, match="transcript"):
        serialization.vk_from_json(text.replace(f'"{vk.transcript}"', '"sha3"'))


def test_setup_npz_round_trip(case, tmp_path):
    """Every array of the loaded setup is the saved one's."""
    import torch

    path = str(tmp_path / "setup.npz")
    serialization.save_setup(path, case.setup)
    loaded = serialization.load_setup(path, device="cpu")
    assert loaded.vk.to_dict() == case.setup.vk.to_dict()
    assert loaded.setup_tree.get_cap() == case.setup.setup_tree.get_cap()
    assert loaded.non_residues == case.setup.non_residues
    assert loaded.selector_paths == case.setup.selector_paths
    for name in ("sigma_cols", "constant_cols"):
        np.testing.assert_array_equal(getattr(loaded, name), getattr(case.setup, name))
    for a, b in [(loaded.setup_monomials, case.setup.setup_monomials),
                 (loaded.setup_lde, case.setup.setup_lde),
                 *zip(loaded.setup_tree.layers, case.setup.setup_tree.layers, strict=True)]:
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("kind", sorted(transcript.TRANSCRIPTS))
def test_transcript_kind_matches_jax(kind):
    """The same challenges from the same absorbs, squeezes between absorbs
    and runs past one squeezed block included."""
    assert sorted(transcript.TRANSCRIPTS) == sorted(jtranscript.TRANSCRIPTS)
    rng = random.Random(kind)
    ours, theirs = transcript.make_transcript(kind), jtranscript.make_transcript(kind)
    for step in range(4):
        els = [rng.randrange(1 << 64) for _ in range(rng.randrange(1, 14))]
        for t in (ours, theirs):
            t.witness_field_elements(els)
            t.witness_merkle_tree_cap([els[:4], els[-4:]])
        got = [ours.get_multiple_challenges(11), ours.get_ext_challenge()]
        want = [theirs.get_multiple_challenges(11), theirs.get_ext_challenge()]
        assert got == want, step


def test_unknown_transcript_kind_refused():
    with pytest.raises(ValueError, match="transcript"):
        transcript.make_transcript("sha3")
    with pytest.raises(ValueError, match="transcript"):
        ProofConfig(transcript="sha3")


def test_legacy_poseidon_matches_jax():
    import torch

    rng = np.random.default_rng(50)
    states = rng.integers(0, P, size=(4, 12), dtype=np.uint64)
    perm = gf.to_numpy(poseidon.poseidon_permutation(gf.from_numpy(states)))
    for i in range(4):
        want = jposeidon.poseidon_permutation_host(list(states[i]))
        assert poseidon.poseidon_permutation_host(list(states[i])) == want
        assert [int(x) for x in perm[i]] == want
    vals = rng.integers(0, P, size=(3, 11), dtype=np.uint64)
    digests = gf.to_numpy(poseidon.leaf_hash(gf.from_numpy(vals)))
    for i in range(3):
        want = jposeidon.PoseidonSpongeHost.hash_leaf(list(vals[i]))
        assert [int(x) for x in digests[i]] == want
        assert poseidon.PoseidonSpongeHost.hash_leaf(list(vals[i])) == want
    assert isinstance(poseidon.poseidon_permutation(torch.zeros(12, dtype=torch.int64)),
                      torch.Tensor)


@pytest.mark.parametrize("runner", ["blake2s", "keccak256"])
def test_byte_pow_runners_match_jax(runner):
    grind, check = (getattr(pow, f"{runner}_pow_grind"), getattr(pow, f"{runner}_pow_verify"))
    jgrind = getattr(jpow, f"{runner}_pow_grind")

    def fresh(m):
        t = m.make_transcript("blake2s")
        t.witness_field_elements([42])
        return t

    t, jt = fresh(transcript), fresh(jtranscript)
    nonce = grind(t, 8)
    assert nonce == jgrind(jt, 8)
    assert t.get_challenge() == jt.get_challenge()
    assert check(fresh(transcript), 8, nonce)
    assert not check(fresh(transcript), 8, nonce + 1)


def test_refused_options():
    with pytest.raises(ValueError):
        ProofConfig(fri_folding_schedule=[3, 0])
    with pytest.raises(ValueError):
        ProofConfig(quotient_degree=12)
    asm = fma_circuit().into_assembly()
    # the fma circuit's constraints need 8 cosets
    with pytest.raises(ValueError, match="quotient_degree"):
        generate_setup(asm, ProofConfig(quotient_degree=4, **BASE), device="cpu")
    cfg = ProofConfig(fri_folding_schedule=[3, 3], **BASE)  # 5 folds to degree 8
    with pytest.raises(ValueError, match="must sum to 5"):
        prove(asm, generate_setup(asm, cfg, device="cpu"), cfg, device="cpu")


def test_convenience_drivers(tmp_path):
    """prove_one_shot, then the same proof from the setup saved and loaded."""
    cfg = ProofConfig(transcript="keccak256", **BASE)
    asm, setup, proof = prove_one_shot(fma_circuit(), cfg, device="cpu")
    assert verify_circuit(setup.vk, proof, asm.gates)
    path = str(tmp_path / "setup.npz")
    serialization.save_setup(path, setup)
    asm2, setup2 = prepare_setup_and_vk(fma_circuit(), cfg, device="cpu")
    assert setup2.vk.to_dict() == setup.vk.to_dict()
    again = prove_from_precomputations(asm2, serialization.load_setup(path, device="cpu"), cfg,
                                       device="cpu")
    assert again.to_json() == proof.to_json()
