"""boojum_tpu_torch's streamed commits against boojum_tpu's on the CPU, word
for word (tolerance 0: every value is an exact field element), inputs from
numpy seeds: the plain versions of kernel B4 (the bare Poseidon2
permutation and the block absorb), the streamed leaf digests, the
MonomialSource regenerations and DEEP block offsets, and the decision to
stream at the geometries of the cells the port proves on the card. The
whole streamed proofs are in test_torch_prover.py, test_torch_lookup_general.py
and test_torch_witness.py."""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_lookup_general import build_circuit as jax_general_circuit
from test_witness_columns import build_circuit as jax_witness_circuit

from boojum_tpu.cs.implementations import ConstraintSystem as JConstraintSystem
from boojum_tpu.cs.types import CSGeometry as JCSGeometry
from boojum_tpu.cs.types import LookupParameters as JLookupParameters
from boojum_tpu.gadgets import allocate_u8_input as jallocate_u8_input
from boojum_tpu.gadgets import sha256 as jsha256
from boojum_tpu.hashes import poseidon2 as jp2
from boojum_tpu.prover import prover as jprover
from boojum_tpu.prover import streaming as jstreaming
from boojum_tpu.prover.setup import build_selector_tree as jbuild_selector_tree
from boojum_tpu.prover.stages import chunk_columns as jchunk_columns
from boojum_tpu_torch.circuits import (
    build_fma, build_general_lookup, build_sha256, build_zero_check_witness,
)
from boojum_tpu_torch.hashes import poseidon2 as tp2
from boojum_tpu_torch.merkle import leaf_digests_device
from boojum_tpu_torch.ntt import lde_from_monomial
from boojum_tpu_torch.prover import streaming
from boojum_tpu_torch.prover.layout import OracleLayout
from boojum_tpu_torch.prover.setup import build_selector_tree, quotient_degree_for
from torch_port_util import bench_function, rand_words, to_np, to_t


def test_permutation_matches_jax():
    state = rand_words(np.random.default_rng(4), 96, 12)
    want = np.asarray(jp2.poseidon2_permutation_xla(jnp.asarray(state)))
    s = to_t(state)
    np.testing.assert_array_equal(to_np(tp2.permutation_plain(s)), want)
    np.testing.assert_array_equal(to_np(tp2.poseidon2_permutation(s)), want)
    np.testing.assert_array_equal(to_np(s), state)  # the input is left as it was


def test_absorb8_matches_jax_sponge_absorb8():
    rng = np.random.default_rng(5)
    state, chunk = rand_words(rng, 64, 12), rand_words(rng, 8, 64)
    want = np.asarray(jstreaming._sponge_absorb8(jnp.asarray(state), jnp.asarray(chunk.T)))
    s = to_t(state)
    assert tp2.absorb_cols(s, to_t(chunk)) is s
    np.testing.assert_array_equal(to_np(s), want)


@pytest.mark.parametrize("b", [3, 8, 13])
def test_absorb_cols_matches_jax(b):
    """A block of b columns: full chunks in order, the trailing partial
    chunk zero-padded (streaming.py _absorb_cols)."""
    rng = np.random.default_rng(b)
    state, cols = rand_words(rng, 64, 12), rand_words(rng, b, 64)
    want = np.asarray(jstreaming._absorb_cols(jnp.asarray(state), jnp.asarray(cols.T)))
    s = to_t(state)
    tp2.absorb_cols(s, to_t(cols))
    np.testing.assert_array_equal(to_np(s), want)


def test_absorb_cols_rejects_bad_blocks():
    s = torch.zeros((16, 12), dtype=torch.int64)
    for cols in (torch.zeros((0, 16), dtype=torch.int64),
                 torch.zeros((8, 15), dtype=torch.int64)):
        with pytest.raises(ValueError):
            tp2.absorb_cols(s, cols)
    with pytest.raises(ValueError):
        tp2.poseidon2_permutation(torch.zeros((16, 8), dtype=torch.int64))


@pytest.mark.parametrize("L", [2, 4])
@pytest.mark.parametrize("b", [5, 8, 40, 67])
def test_streamed_leaf_digests_match_jax_and_leaf_hash(b, L):
    """Under one chunk, one chunk, across a block, a trailing partial chunk:
    the JAX package's streamed digests and the port's leaf_hash over the
    whole LDE."""
    mono = rand_words(np.random.default_rng(100 * b + L), b, 64)
    got = to_np(streaming.streamed_leaf_digests_blocks(to_t(mono), L))
    want = np.asarray(jstreaming.streamed_leaf_digests_blocks(jnp.asarray(mono), L))
    np.testing.assert_array_equal(got, want)
    whole = to_np(leaf_digests_device(lde_from_monomial(to_t(mono), L)))
    np.testing.assert_array_equal(got, whole)


def test_commit_streaming_cap_matches_jax():
    mono = rand_words(np.random.default_rng(9), 40, 64)
    tree = streaming.commit_streaming(to_t(mono), 4, 8)
    jtree = jstreaming.commit_streaming(jnp.asarray(mono), 4, 8)
    assert tree.get_cap() == jtree.get_cap()
    assert tree.get_proofs([0, 77, 255]) == jtree.get_proofs([0, 77, 255])


def test_monomial_source_matches_jax():
    mono = rand_words(np.random.default_rng(11), 37, 32)
    src = streaming.MonomialSource(to_t(mono), 4)
    jsrc = jstreaming.MonomialSource(jnp.asarray(mono), 4)
    assert src.shape == jsrc.shape == (37, 128)
    idx = np.array([0, 5, 127, 64, 5], dtype=np.int64)
    np.testing.assert_array_equal(to_np(src.gather_rows(torch.from_numpy(idx))),
                                  np.asarray(jsrc.gather_rows(jnp.asarray(idx))))
    idxs = (0, 1, 33, 36)
    np.testing.assert_array_equal(to_np(src.columns(idxs)),
                                  np.asarray(jprover._cols_from_mono(jnp.asarray(mono),
                                                                     idxs, 4)))
    for (i, blk), (ji, jblk) in zip(src.blocks(), jsrc.blocks()):
        assert i == ji
        np.testing.assert_array_equal(to_np(blk), np.asarray(jblk))


def test_deep_source_blocks_match_jax():
    """Offsets and blocks over a tensor, a MonomialSource and a tensor, the
    tensors sliced by a byte budget of three columns."""
    rng = np.random.default_rng(12)
    a, mono, c = rand_words(rng, 7, 64), rand_words(rng, 40, 16), rand_words(rng, 2, 64)
    per_bytes = 3 * 64 * 8
    got = list(streaming.deep_source_blocks(
        [to_t(a), streaming.MonomialSource(to_t(mono), 4), to_t(c)], per_bytes))
    want = list(jstreaming.deep_source_blocks(
        [jnp.asarray(a), jstreaming.MonomialSource(jnp.asarray(mono), 4), jnp.asarray(c)],
        per_bytes))
    assert [off for _b, off in got] == [off for _b, off in want] == [
        0, 3, 6, 7, 39, 47]
    for (g, _), (w, _) in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))


@lru_cache(maxsize=1)
def _sha256_assemblies():
    """sha256 of the empty message in both packages: bench.py's geometry and
    lookups, whatever the message length."""
    cs = JConstraintSystem(JCSGeometry(60, 0, 8, 7), 1 << 17,
                           lookup_params=JLookupParameters(width=4, num_repetitions=8))
    jsha256(cs, jallocate_u8_input(cs, b""))
    return cs.into_assembly(), build_sha256(message=b"")[0].into_assembly()


def _assemblies(circuit):
    if circuit == "fma":
        return bench_function("build_fma")(8).into_assembly(), build_fma(8).into_assembly()
    if circuit == "general":
        return (jax_general_circuit()[0].into_assembly(),
                build_general_lookup()[0].into_assembly())
    if circuit == "witness":
        return (jax_witness_circuit()[0].into_assembly(),
                build_zero_check_witness()[0].into_assembly())
    return _sha256_assemblies()


def _jax_estimate(ja):
    """The JAX prover's total_cols (prover.py _prove_impl) and its setup's
    column count, from the JAX assembly, with the JAX setup's quotient
    degree."""
    Cg, LC = ja.copy_placement.shape[0], ja.num_lookup_cols
    Ct, W = Cg + LC, ja.wit_placement.shape[0]
    M = 1 if ja.lookups_enabled else 0
    K = ja.geometry.num_constant_columns + (1 if ja.lookup_mode == "specialized" else 0)
    TW = ja.lookup_params.width + 1 if ja.lookups_enabled else 0
    deg = ja.geometry.max_allowed_constraint_degree
    S_est = 2 * len(jchunk_columns(Ct, deg)) + 2 * ja.num_lookup_subargs + 2 * M
    tree_degree, _ = jbuild_selector_tree(ja.gates)[0].compute_stats()
    Q = 1 << (max(tree_degree, deg + 1, 1) - 1).bit_length()
    return (Ct + W + M) + (Ct + K + TW) + S_est + 2 * Q, Ct + K + TW


@pytest.mark.parametrize("circuit,log_n,L,prover_streams,setup_streams", [
    ("fma", 20, 4, True, False),
    ("general", 20, 8, True, False),
    ("witness", 20, 8, True, False),
    ("sha256", 16, 8, False, False),
    ("sha256", 20, 2, True, True),
], ids=["fma-2^20", "general-2^20", "witness-2^20", "sha256-8KiB-2^16",
        "sha256-128KiB-2^20"])
def test_stream_decision_matches_jax(monkeypatch, circuit, log_n, L, prover_streams,
                                     setup_streams):
    monkeypatch.delenv("BOOJUM_TPU_STREAM_LDE", raising=False)
    ja, ta = _assemblies(circuit)
    N = (1 << log_n) * L
    jax_total, jax_setup_cols = _jax_estimate(ja)
    tree, paths = build_selector_tree(ta.gates)
    layout = OracleLayout.for_assembly(ta, paths)
    total = layout.streamed_columns_estimate(quotient_degree_for(ta, tree), L)
    assert (total, layout.num_setup_rows) == (jax_total, jax_setup_cols)
    assert streaming.use_streamed_lde(total, N) == jstreaming.use_streamed_lde(
        jax_total, N) == prover_streams
    assert streaming.use_streamed_lde(layout.num_setup_rows, N) == (
        jstreaming.use_streamed_lde(jax_setup_cols, N)) == setup_streams


def test_stream_thresholds_force_either_path():
    assert streaming.use_streamed_lde(1, 2, 0)
    assert not streaming.use_streamed_lde(1 << 20, 1 << 30, float("inf"))
    assert streaming.STREAM_THRESHOLD_BYTES == 1536 << 20 == jstreaming.stream_threshold_bytes()
