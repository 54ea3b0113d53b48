"""boojum_tpu_torch Poseidon2 (plain version of kernel B5), Merkle trees and
transcript against the JAX package, word for word."""

import jax.numpy as jnp
import numpy as np
import pytest

from boojum_tpu import merkle as jmerkle
from boojum_tpu.hashes import poseidon2 as jp2
from boojum_tpu.transcript import BitSource as JBitSource
from boojum_tpu.transcript import Poseidon2Transcript as JTranscript
from boojum_tpu_torch import merkle as tmerkle
from boojum_tpu_torch.hashes import poseidon2 as tp2
from boojum_tpu_torch.transcript import BitSource, Poseidon2Transcript
from torch_port_util import rand_words, to_np, to_t


def test_permutation_matches_jax():
    state = rand_words(np.random.default_rng(0), 64, 12)
    want = np.asarray(jp2.poseidon2_permutation_xla(jnp.asarray(state)))
    got = tp2.permute_plain([to_t(state[:, i].copy()) for i in range(12)])
    np.testing.assert_array_equal(np.stack([to_np(g) for g in got], axis=1), want)
    assert tp2.poseidon2_permutation_host([int(v) for v in state[0]]) == [
        int(v) for v in want[0]
    ]


@pytest.mark.parametrize("width", [1, 7, 8, 9, 16, 22])
def test_leaf_hash_matches_jax(width):
    cols = rand_words(np.random.default_rng(width), width, 128)
    want = np.asarray(jp2.leaf_hash_xla(jnp.asarray(cols.T)))
    np.testing.assert_array_equal(to_np(tmerkle.leaf_hash(to_t(cols))), want)


def test_node_hash_matches_jax():
    layer = rand_words(np.random.default_rng(1), 256, 4)
    want = np.asarray(jp2.node_hash_xla(jnp.asarray(layer[0::2]), jnp.asarray(layer[1::2])))
    np.testing.assert_array_equal(to_np(tp2.node_hash(to_t(layer))), want)


@pytest.mark.parametrize("B,L,n,cap", [(16, 4, 64, 16), (3, 2, 32, 4)])
def test_tree_layers_caps_and_paths_match_jax(B, L, n, cap):
    lde = rand_words(np.random.default_rng(B + n), B, L, n)
    want = jmerkle.commit_layers_device(jnp.asarray(lde), cap)
    got = tmerkle.commit_layers_device(to_t(lde), cap)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))
    tree = tmerkle.MerkleTreeWithCap(got, cap)
    jtree = jmerkle.MerkleTreeWithCap.from_layers(list(want), cap)
    assert tree.get_cap() == jtree.get_cap()
    idxs = [0, 5, L * n - 1, 17]
    paths = tree.get_proofs(idxs)
    assert paths == jtree.get_proofs(idxs)
    flat = lde.reshape(B, -1)
    for i, path in zip(idxs, paths):
        leaf = [int(v) for v in flat[:, i]]
        assert jmerkle.verify_proof_over_cap(leaf, path, tree.get_cap(), i)
        assert tmerkle.verify_proof_over_cap(leaf, path, tree.get_cap(), i)
        assert not tmerkle.verify_proof_over_cap(leaf, path, tree.get_cap(), i ^ 1)


def test_transcript_challenges_and_query_bits_match_jax():
    rng = np.random.default_rng(2)
    ours, theirs = Poseidon2Transcript(), JTranscript()
    for step in range(6):
        vals = [int(v) for v in rand_words(rng, step * 3 + 1)]
        ours.witness_field_elements(vals)
        theirs.witness_field_elements(vals)
        assert ours.get_ext_challenge() == theirs.get_ext_challenge()
        assert ours.get_multiple_challenges(3) == theirs.get_multiple_challenges(3)
    bits, jbits = BitSource(22), JBitSource(22)
    assert [bits.get_index(ours, 22) for _ in range(40)] == [
        jbits.get_index(theirs, 22) for _ in range(40)
    ]


def test_sponge_host_matches_jax():
    vals = [int(v) for v in rand_words(np.random.default_rng(3), 19)]
    assert tp2.Poseidon2SpongeHost.hash_leaf(vals) == jp2.Poseidon2SpongeHost.hash_leaf(vals)
    assert tp2.Poseidon2SpongeHost.hash_node(vals[:4], vals[4:8]) == (
        jp2.Poseidon2SpongeHost.hash_node(vals[:4], vals[4:8])
    )
