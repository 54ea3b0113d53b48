"""boojum_tpu_torch's prover against boojum_tpu's on the bench.py fma-chain
circuit at 2^8 rows (CPU, plain versions of every kernel): synthesis,
setup, the quotient sweep on one coset, the FRI fold, the checkpoint stream
and the proof bytes (materialized, and with every commit streamed), each
word for word, and each package's verifier on the other's proof."""

import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from boojum_tpu.prover import ProofConfig as JProofConfig
from boojum_tpu.prover import generate_setup as jgenerate_setup
from boojum_tpu.prover import prove as jprove
from boojum_tpu.prover import verify as jverify
from boojum_tpu.prover import fri as jfri
from boojum_tpu.prover import prover as jprover
from boojum_tpu.prover.proof import Proof as JProof
from boojum_tpu.prover.stages import chunk_columns as jchunk_columns
from boojum_tpu.utils.report import CheckpointLog as JCheckpointLog
from boojum_tpu.utils.report import install_checkpoint_log
from boojum_tpu_torch.circuits import build_fma
from boojum_tpu_torch.compat import assembly_from_arrays, setup_from_arrays
from boojum_tpu_torch.cs.types import CSGeometry
from boojum_tpu_torch.prover import ProofConfig, generate_setup, prove, verify
from boojum_tpu_torch.prover import fri as tfri
from boojum_tpu_torch.prover import quotient_sweep as qs
from boojum_tpu_torch.prover.proof import Proof
from boojum_tpu_torch.utils.report import CheckpointLog
from torch_port_util import bench_function, rand_words, to_np, to_t

LOG_N = 8
CONFIG = dict(fri_lde_factor=4, merkle_tree_cap_size=16, num_queries=50,
              pow_bits=0, fri_final_degree=16)


@pytest.fixture(scope="module")
def jax_run():
    asm = bench_function("build_fma")(LOG_N).into_assembly()
    cfg = JProofConfig(**CONFIG)
    setup = jgenerate_setup(asm, cfg)
    log = JCheckpointLog()
    prev = install_checkpoint_log(log)
    try:
        proof = jprove(asm, setup, cfg)
    finally:
        install_checkpoint_log(prev)
    stream = [(e["round"], e["label"], e["digest"]) for e in log.entries]
    return SimpleNamespace(asm=asm, setup=setup, cfg=cfg, proof=proof, stream=stream)


@pytest.fixture(scope="module")
def port_run():
    asm = build_fma(LOG_N).into_assembly()
    cfg = ProofConfig(**CONFIG)
    setup = generate_setup(asm, cfg, device="cpu")
    log = CheckpointLog()
    proof = prove(asm, setup, cfg, device="cpu", log=log)
    return SimpleNamespace(asm=asm, setup=setup, cfg=cfg, proof=proof, stream=log.stream())


@pytest.fixture(scope="module")
def stream_run():
    """The port's setup and prove with every commit streamed (threshold 0)."""
    asm = build_fma(LOG_N).into_assembly()
    cfg = ProofConfig(**CONFIG)
    setup = generate_setup(asm, cfg, device="cpu", stream_threshold_bytes=0)
    assert setup.setup_lde is None
    log = CheckpointLog()
    proof = prove(asm, setup, cfg, device="cpu", log=log, stream_threshold_bytes=0)
    return SimpleNamespace(asm=asm, setup=setup, cfg=cfg, proof=proof, stream=log.stream())


@pytest.fixture(scope="module")
def compat_run(jax_run):
    """The port's prover on the JAX package's assembly and setup columns."""
    ja, js = jax_run.asm, jax_run.setup
    asm = assembly_from_arrays(
        geometry=dataclasses.astuple(ja.geometry),
        trace_len=ja.trace_len,
        gate_names=[g.name for g in ja.gates],
        row_gate=ja.row_gate,
        gate_constants=ja.gate_constants,
        copy_placement=ja.copy_placement,
        copy_values=ja.copy_cols_values,
        public_inputs=ja.public_inputs,
    )
    cfg = ProofConfig(**CONFIG)
    setup = setup_from_arrays(
        asm, cfg, sigma_cols=js.sigma_cols, constant_cols=js.constant_cols,
        selector_paths=js.selector_paths, non_residues=js.non_residues,
        quotient_degree=js.vk.quotient_degree, device="cpu",
    )
    log = CheckpointLog()
    proof = prove(asm, setup, cfg, device="cpu", log=log)
    return SimpleNamespace(asm=asm, setup=setup, proof=proof, stream=log.stream())


def test_synthesis_matches_jax_assembly(jax_run, port_run):
    ja, ta = jax_run.asm, port_run.asm
    assert ta.trace_len == ja.trace_len == 1 << LOG_N
    assert [g.name for g in ta.gates] == [g.name for g in ja.gates]
    np.testing.assert_array_equal(ta.row_gate, ja.row_gate)
    assert ta.gate_constants == ja.gate_constants
    np.testing.assert_array_equal(ta.copy_placement, ja.copy_placement)
    np.testing.assert_array_equal(ta.copy_cols_values, ja.copy_cols_values)
    assert ta.public_inputs == [tuple(p) for p in ja.public_inputs]


def test_setup_matches_jax(jax_run, port_run):
    js, ts = jax_run.setup, port_run.setup
    np.testing.assert_array_equal(ts.sigma_cols, js.sigma_cols)
    np.testing.assert_array_equal(ts.constant_cols, js.constant_cols)
    assert ts.selector_paths == js.selector_paths
    assert ts.non_residues == js.non_residues
    assert ts.vk.quotient_degree == js.vk.quotient_degree == 4
    assert ts.vk.setup_merkle_cap == js.vk.setup_merkle_cap
    np.testing.assert_array_equal(to_np(ts.setup_monomials), np.asarray(js.setup_monomials))


def test_compat_reproduces_setup_cap(jax_run, compat_run):
    assert compat_run.setup.vk.setup_merkle_cap == jax_run.setup.vk.setup_merkle_cap


@pytest.mark.parametrize("run", ["port_run", "compat_run", "stream_run"])
def test_checkpoint_stream_matches_jax(request, jax_run, run):
    stream = request.getfixturevalue(run).stream
    assert [s[:2] for s in stream] == [s[:2] for s in jax_run.stream]
    assert stream == jax_run.stream


@pytest.mark.parametrize("run", ["port_run", "compat_run", "stream_run"])
def test_proof_bytes_match_jax(request, jax_run, run):
    assert request.getfixturevalue(run).proof.to_json() == jax_run.proof.to_json()


def test_port_verifier_accepts(port_run):
    assert verify(port_run.setup.vk, port_run.proof, port_run.asm.gates)


@pytest.mark.parametrize("where", [
    "values_at_z", "witness_cap", "final_fri_monomials", "query_leaf", "query_path",
    "public_inputs",
])
def test_port_verifier_rejects_tampering(port_run, where):
    d = json.loads(port_run.proof.to_json())
    if where == "values_at_z":
        d["values_at_z"][3][0] = (d["values_at_z"][3][0] + 1) % (2**64 - 2**32 + 1)
    elif where == "witness_cap":
        d["witness_cap"][0][1] ^= 1
    elif where == "final_fri_monomials":
        d["final_fri_monomials"][0][1] += 1
    elif where == "query_leaf":
        d["queries"][7]["witness"]["leaf_values"][2] += 1
    elif where == "query_path":
        d["queries"][3]["fri"][1]["path"][0][0] ^= 4
    else:
        d["public_inputs"][0] += 1
    bad = Proof.from_json(json.dumps(d))
    assert not verify(port_run.setup.vk, bad, port_run.asm.gates)


def test_jax_verifier_accepts_port_proof(jax_run, port_run):
    proof = JProof.from_json(port_run.proof.to_json())
    assert jverify(jax_run.setup.vk, proof, jax_run.asm.gates)


@pytest.mark.parametrize("seed", [0, 1])
def test_sweep_plain_matches_jax_u64_core(jax_run, seed):
    """One coset of the fma assembly's quotient terms, random coset values,
    against prover.py _u64_sweep_core."""
    ja, js = jax_run.asm, jax_run.setup
    rng = np.random.default_rng(seed)
    n, Ct, K = ja.trace_len, 16, 6
    chunks = jchunk_columns(Ct, 3)
    plan = qs.SweepPlan(port_gates(ja), js.selector_paths, port_geometry(ja), Ct, "cpu")
    total = plan.num_alpha
    lk_ctx = (False, "none", 0, 0, len(chunks) - 1, tuple(tuple(c) for c in chunks),
              total, Ct, Ct, 0, K, 0, None)
    core = jax.jit(jprover._u64_sweep_core(ja, js.selector_paths, js.non_residues, lk_ctx))
    wit, setup_v, s2, zs = (rand_words(rng, r, n) for r in (Ct, Ct + K, 2 * len(chunks), 2))
    xs, l0, zhinv = (rand_words(rng, n) for _ in range(3))
    alpha, beta, gamma = (tuple(int(v) for v in rand_words(rng, 2)) for _ in range(3))
    from boojum_tpu.field import extension as jext

    pows = jext.powers_s(alpha, total)
    ap0 = jnp.asarray(np.array([p[0] for p in pows], dtype=np.uint64))
    ap1 = jnp.asarray(np.array([p[1] for p in pows], dtype=np.uint64))
    pair = lambda s: jnp.asarray(np.array(s, dtype=np.uint64))  # noqa: E731
    want = core(*(jnp.asarray(a) for a in (wit, setup_v, s2, zs, xs, l0, zhinv)),
                ap0, ap1, pair(beta), pair(gamma), pair((0, 0)), pair((0, 0)))
    table = qs.sweep_table(plan, alpha, beta, gamma, js.non_residues, "cpu")
    got = qs.coset_terms(plan, *(to_t(a) for a in (wit, setup_v, s2, zs, xs, l0, zhinv)),
                         table)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))


def port_gates(ja):
    from boojum_tpu_torch.cs.gates import GATES_BY_NAME

    return [GATES_BY_NAME[g.name].instance() for g in ja.gates]


def port_geometry(ja):
    return CSGeometry(*dataclasses.astuple(ja.geometry))


@pytest.mark.parametrize("log_n", [3, 10])
def test_fold_and_tables_match_jax(log_n):
    rng = np.random.default_rng(log_n)
    tables = tfri.fold_challenge_tables(log_n, 2, "cpu")
    jtables = jfri.fold_challenge_tables(log_n, 2)
    for t, j in zip(tables, jtables):
        np.testing.assert_array_equal(to_np(t), np.asarray(j))
    c0, c1 = rand_words(rng, 1 << log_n), rand_words(rng, 1 << log_n)
    ch = tuple(int(v) for v in rand_words(rng, 2))
    want = jfri._fold_once_jit((jnp.asarray(c0), jnp.asarray(c1)),
                               (jnp.uint64(ch[0]), jnp.uint64(ch[1])), jtables[0])
    got = tfri.fold_once(to_t(c0), to_t(c1), ch, tables[0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))


def test_fold_schedule_matches_jax():
    for base, final in ((1 << 8, 16), (1 << 20, 16), (1 << 12, 8), (64, 32)):
        assert tfri.fold_schedule(base, final) == jfri.fold_schedule(base, final)
