"""boojum_tpu_torch's BabyBear field, Poseidon2 (the plain versions of kernel
B8), NTT, transcript and proof of work against boojum_tpu's, word for word
(tolerance 0: every value is an exact field element), on inputs made from
numpy seeds, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boojum_tpu.field import babybear as jbb
from boojum_tpu.hashes import poseidon2_bb as jp2
from boojum_tpu.ntt import bb_ntt as jntt
from boojum_tpu.prover import pow as jpow
from boojum_tpu.transcript import BitSource as JBitSource
from boojum_tpu.transcript import Poseidon2BabyBearTranscript as JTranscript
from boojum_tpu_torch.field import babybear as bb
from boojum_tpu_torch.hashes import poseidon2_bb as p2
from boojum_tpu_torch.ntt import bb_ntt
from boojum_tpu_torch.prover import pow as tpow
from boojum_tpu_torch.transcript import BitSource, Poseidon2BabyBearTranscript

P = bb.P
BOUNDARY = np.array([0, 1, 2, P - 1, P - 2, (P + 1) // 2, (1 << 30) + 5, 1 << 27, 7],
                    dtype=np.uint32)


def _rand(rng, *shape):
    return rng.integers(0, P, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return bb.from_numpy(a)


def _np(t):
    return bb.to_numpy(t)


def _pairs(rng):
    """Random pairs plus every pair of boundary values (sums past 2^31)."""
    a = np.concatenate([np.repeat(BOUNDARY, len(BOUNDARY)), _rand(rng, 500)])
    b = np.concatenate([np.tile(BOUNDARY, len(BOUNDARY)), _rand(rng, 500)])
    return a, b


def test_field_record_matches_jax():
    import dataclasses

    from boojum_tpu.field.spec import BABYBEAR as J
    from boojum_tpu_torch.field.spec import BABYBEAR

    assert dataclasses.astuple(BABYBEAR) == dataclasses.astuple(J)
    assert jbb.P == bb.P == (1 << 31) - (1 << 27) + 1
    for log_n in (0, 1, 10, 20, 27):
        assert bb.omega(log_n) == jbb.omega(log_n)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_tensor_ops_match_jax_and_do_not_wrap(op):
    rng = np.random.default_rng(1)
    a, b = _pairs(rng)
    got = _np(getattr(bb, op)(_t(a), _t(b)))
    want = np.asarray(getattr(jbb, op)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    py = {"add": lambda x, y: (x + y) % P, "sub": lambda x, y: (x - y) % P,
          "mul": lambda x, y: x * y % P}[op]
    np.testing.assert_array_equal(got, [py(int(x), int(y)) for x, y in zip(a, b)])
    assert getattr(bb, op)(_t(a), _t(b)).dtype == torch.int32


def test_neg_pow_inv_match_jax():
    rng = np.random.default_rng(2)
    a = np.concatenate([BOUNDARY, _rand(rng, 300)])
    np.testing.assert_array_equal(_np(bb.neg(_t(a))), np.asarray(jbb.neg(jnp.asarray(a))))
    np.testing.assert_array_equal(_np(bb.inv(_t(a))), np.asarray(jbb.inv(jnp.asarray(a))))
    for e in (0, 1, 7, 1 << 30, P - 2):
        np.testing.assert_array_equal(_np(bb.pow_const(_t(a), e)),
                                      [pow(int(x), e, P) for x in a])


def test_host_scalars_match_jax():
    rng = np.random.default_rng(3)
    for x, y in zip(_rand(rng, 50), np.concatenate([BOUNDARY, _rand(rng, 41)])):
        x, y = int(x), int(y)
        assert bb.add_s(x, y) == jbb.add_s(x, y) and bb.sub_s(x, y) == jbb.sub_s(x, y)
        assert bb.mul_s(x, y) == jbb.mul_s(x, y) and bb.neg_s(y) == jbb.neg_s(y)
    e = tuple(int(v) for v in _rand(rng, 4))
    f = tuple(int(v) for v in _rand(rng, 4))
    assert bb.ext_mul_s(e, f) == jbb.ext_mul_s(e, f)
    assert bb.ext_inv_s(e) == jbb.ext_inv_s(e)
    assert bb.ext_mul_s(e, bb.ext_inv_s(e)) == bb.ONE_S
    assert bb.ext_pow_s(e, 12345) == jbb.ext_pow_s(e, 12345)
    for k in (1, 2, 3):
        assert bb.ext_frobenius_s(e, k) == jbb.ext_frobenius_s(e, k)


def test_ext_ops_match_jax():
    rng = np.random.default_rng(4)
    a = tuple(_rand(rng, 4, 200))
    b = tuple(_rand(rng, 4, 200))
    a[0][:3] = [0, P - 1, 1]
    ta, tb = _t(np.stack(a)), _t(np.stack(b))
    np.testing.assert_array_equal(_np(bb.ext_mul(ta, tb)), np.stack(jbb.ext_mul_np(a, b)))
    np.testing.assert_array_equal(_np(bb.ext_add(ta, tb)), np.stack(jbb.ext_add_np(a, b)))
    np.testing.assert_array_equal(_np(bb.ext_sub(ta, tb)), np.stack(jbb.ext_sub_np(a, b)))
    np.testing.assert_array_equal(_np(bb.ext_inv(ta)), np.stack(jbb.ext_inv_np(a)))
    s = tuple(int(v) for v in _rand(rng, 4))
    np.testing.assert_array_equal(
        _np(bb.ext_mul(ta, s)), np.stack(jbb.ext_mul_np(a, tuple(np.uint32(v) for v in s))))
    short = tuple(x[:37] for x in a)
    np.testing.assert_array_equal(_np(bb.ext_prefix_product(_t(np.stack(short)))),
                                  np.stack(jbb.ext_prefix_product_np(short)))
    z = tuple(int(v) for v in _rand(rng, 4))
    np.testing.assert_array_equal(_np(bb.ext_powers(z, 77, "cpu")).T,
                                  np.array(bb.ext_powers_s(z, 77), dtype=np.uint32))


@pytest.mark.parametrize("log_n", [0, 1, 5, 10])
def test_ntt_matches_jax(log_n):
    rng = np.random.default_rng(10 + log_n)
    x = _rand(rng, 3, 1 << log_n)
    np.testing.assert_array_equal(_np(bb_ntt.ntt(_t(x), inverse=True)), jntt.ntt_np(x, True))
    np.testing.assert_array_equal(_np(bb_ntt.ntt(_t(x))), jntt.ntt_np(x, False))


@pytest.mark.parametrize("lde_factor", [2, 4, 8])
def test_coset_lde_matches_jax(lde_factor):
    rng = np.random.default_rng(20 + lde_factor)
    mono = _rand(rng, 5, 1 << 8)
    np.testing.assert_array_equal(_np(bb_ntt.lde(_t(mono), lde_factor, 31)),
                                  jntt.lde_np(mono, lde_factor, 31))


def test_lde_rows_in_blocks_match_one_block(monkeypatch):
    rng = np.random.default_rng(5)
    mono = _t(_rand(rng, 7, 1 << 6))
    whole = bb_ntt.lde(mono, 4)
    monkeypatch.setattr(bb_ntt, "BLOCK_ELEMS", 1 << 9)  # two rows a block
    assert torch.equal(bb_ntt.lde(mono, 4), whole)


def test_permutation_plain_matches_jax_numpy():
    rng = np.random.default_rng(6)
    states = _rand(rng, 300, 16)
    states[0] = 0
    states[1] = P - 1
    want = jp2.poseidon2_permutation_bb_np(states)
    np.testing.assert_array_equal(_np(p2.poseidon2_permutation_bb(_t(states))), want)
    for row in (0, 1, 7):
        assert p2.poseidon2_permutation_bb_host([int(v) for v in states[row]]) == \
            [int(v) for v in want[row]]


def test_permutation_plain_matches_the_pallas_kernel():
    """B8's plain version against the Pallas kernel itself, in interpret mode."""
    rng = np.random.default_rng(20)
    states = _rand(rng, 64, 16)
    states[0] = 0
    states[1] = P - 1
    want = np.asarray(jp2.poseidon2_permutation_bb_pallas(jnp.asarray(states),
                                                          interpret=True))
    np.testing.assert_array_equal(_np(p2.permutation_plain(_t(states))), want)


@pytest.mark.parametrize("width", [1, 8, 9, 44, 48])
def test_leaf_sponge_matches_jax(width):
    rng = np.random.default_rng(30 + width)
    vals = _rand(rng, 33, width)
    want = jp2.leaf_hash_bb_np(vals)
    np.testing.assert_array_equal(_np(p2.leaf_hash_bb(_t(np.ascontiguousarray(vals.T)))),
                                  want)
    assert p2.leaf_hash_bb_host([int(v) for v in vals[3]]) == [int(v) for v in want[3]]


@pytest.mark.parametrize("width", [1, 4, 15])
def test_paired_leaf_sponge_matches_the_concatenated_oracle(width):
    rng = np.random.default_rng(40 + width)
    lde = _rand(rng, width, 64)
    paired = np.concatenate([lde[:, :32], lde[:, 32:]])
    np.testing.assert_array_equal(_np(p2.leaf_hash_bb(_t(lde), paired=True)),
                                  jp2.leaf_hash_bb_np(paired.T))


def test_node_compression_matches_jax():
    rng = np.random.default_rng(7)
    layer = _rand(rng, 128, 8)
    want = jp2.node_hash_bb_np(layer[0::2], layer[1::2])
    np.testing.assert_array_equal(_np(p2.node_layer_bb(_t(layer))), want)
    left, right = _rand(rng, 9, 8), _rand(rng, 9, 8)
    np.testing.assert_array_equal(_np(p2.node_hash_bb(_t(left), _t(right))),
                                  jp2.node_hash_bb_np(left, right))
    assert p2.node_hash_bb_host(left[2], right[2]) == \
        jp2.node_hash_bb_host([int(v) for v in left[2]], [int(v) for v in right[2]])


def test_wrappers_check_their_operands():
    with pytest.raises(TypeError):
        p2.poseidon2_permutation_bb(torch.zeros((4, 16), dtype=torch.int64))
    with pytest.raises(ValueError):
        p2.poseidon2_permutation_bb(torch.zeros((4, 12), dtype=torch.int32))
    with pytest.raises(ValueError):
        p2.leaf_hash_bb(torch.zeros((3, 5), dtype=torch.int32), paired=True)
    with pytest.raises(ValueError):
        p2.node_hash_bb(torch.zeros((4, 8), dtype=torch.int32),
                        torch.zeros((3, 8), dtype=torch.int32))


def test_permutation_op_counts():
    # 8 full rounds of 16 S-boxes and 13 partial rounds of one, 4 multiplies
    # each; 13 internal layers of 16
    muls, adds = p2.permutation_op_counts()
    assert muls == (8 * 16 + 13) * 4 + 13 * 16
    assert adds == 9 * 84 + 8 * 16 + 13 + 13 * 31


def test_transcript_and_bit_source_match_jax():
    rng = np.random.default_rng(8)
    jt, t = JTranscript(), Poseidon2BabyBearTranscript()
    for step in range(6):
        els = [int(v) for v in _rand(rng, 3 + 5 * step)]
        jt.witness_field_elements(els)
        t.witness_field_elements(els)
        assert t.get_ext_challenge() == jt.get_ext_challenge()
        assert t.get_multiple_challenges(step) == jt.get_multiple_challenges(step)
    cap = [tuple(int(v) for v in row) for row in _rand(rng, 4, 8)]
    jt.witness_merkle_tree_cap(cap)
    t.witness_merkle_tree_cap(cap)
    jbs, bs = JBitSource(21, challenge_bits=31), BitSource(21, challenge_bits=31)
    assert [bs.get_index(t, 21) for _ in range(20)] == [jbs.get_index(jt, 21)
                                                        for _ in range(20)]


@pytest.mark.parametrize("bits", [0, 4, 9])
def test_blake2s_pow_matches_jax(bits):
    jt, t = JTranscript(), Poseidon2BabyBearTranscript()
    for tr in (jt, t):
        tr.witness_field_elements([bits, 5, 6])
    nonce = tpow.blake2s_pow_grind(t, bits)
    assert nonce == jpow.blake2s_pow_grind(jt, bits)
    assert t.get_challenge() == jt.get_challenge()
    t2, jt2 = Poseidon2BabyBearTranscript(), JTranscript()
    for tr in (jt2, t2):
        tr.witness_field_elements([bits, 5, 6])
    assert tpow.blake2s_pow_verify(t2, bits, nonce)
    assert jpow.blake2s_pow_verify(jt2, bits, nonce)
    if bits:
        t3 = Poseidon2BabyBearTranscript()
        t3.witness_field_elements([bits, 5, 6])
        assert not tpow.blake2s_pow_verify(t3, bits, nonce + 1) or bits < 2


def test_sha256_over_babybear_is_rejected_at_synthesis():
    from boojum_tpu_torch.circuits import SHA256_GEOMETRY, SHA256_LOOKUP
    from boojum_tpu_torch.cs.implementations import ConstraintSystem, FieldCapacityError
    from boojum_tpu_torch.gadgets import allocate_u8_input, sha256

    cs = ConstraintSystem(SHA256_GEOMETRY, 1 << 15, lookup_params=SHA256_LOOKUP,
                          field="babybear")
    with pytest.raises(FieldCapacityError) as exc:
        sha256(cs, allocate_u8_input(cs, b"abc"))
    msg = str(exc.value)
    assert "babybear" in msg and "goldilocks" in msg


def test_circuits_reduce_modulo_their_field():
    from boojum_tpu_torch.circuits import build_fma

    gl_cs, bb_cs = build_fma(5), build_fma(5, field="babybear")
    assert bb_cs.p == P and gl_cs.p == 0xFFFFFFFF00000001

    def variable_values(cs):  # variable k at place 2k of the resolver's arena
        return cs.resolver.arena(2 * cs.next_var_idx)[0::2]

    assert variable_values(bb_cs).max() < P and variable_values(gl_cs).max() >= P
    assert bb_cs.into_assembly().field == "babybear"
