"""boojum_tpu_torch field ops against boojum_tpu.field, word for word."""

import jax.numpy as jnp
import numpy as np
import pytest

from boojum_tpu.field import extension as jext
from boojum_tpu.field import goldilocks as jgf
from boojum_tpu_torch.field import extension as text
from boojum_tpu_torch.field import gl as tgl
from boojum_tpu_torch.field import goldilocks as tgf
from torch_port_util import BOUNDARY, P, rand_words, to_np, to_t


def _operands(seed):
    rng = np.random.default_rng(seed)
    bx, by = np.meshgrid(BOUNDARY, BOUNDARY)
    a = np.concatenate([bx.ravel(), rand_words(rng, 200)])
    b = np.concatenate([by.ravel(), rand_words(rng, 200)])
    return a, b


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_jax(op):
    a, b = _operands(1)
    want = np.asarray(getattr(jgf, op)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(to_np(getattr(tgf, op)(to_t(a), to_t(b))), want)


@pytest.mark.parametrize("op", ["neg", "double", "sqr"])
def test_unary_ops_match_jax(op):
    a, _ = _operands(2)
    want = np.asarray(getattr(jgf, op)(jnp.asarray(a)))
    np.testing.assert_array_equal(to_np(getattr(tgf, op)(to_t(a))), want)


def test_mul_by_python_int_matches_tensor_mul():
    a, b = _operands(3)
    for k in (0, 1, 7, int(P - 1), 2**63 + 5):
        got = to_np(tgf.mul(to_t(a), k))
        want = np.asarray(jgf.mul(jnp.asarray(a), jnp.uint64(k)))
        np.testing.assert_array_equal(got, want)


def test_reduce128_matches_jax():
    rng = np.random.default_rng(4)
    hi = np.concatenate([rng.integers(0, 2**64 - 1, 300, dtype=np.uint64),
                         np.array([0, 2**64 - 1, 2**32], dtype=np.uint64)])
    lo = np.concatenate([rng.integers(0, 2**64 - 1, 300, dtype=np.uint64),
                         np.array([2**64 - 1, 0, 5], dtype=np.uint64)])
    want = np.asarray(jgf.reduce128(jnp.asarray(hi), jnp.asarray(lo)))
    np.testing.assert_array_equal(to_np(tgf.reduce128(to_t(hi), to_t(lo))), want)


@pytest.mark.parametrize("e", [0, 1, 7, 2**32 + 3, P - 2])
def test_pow_const_matches_jax(e):
    a, _ = _operands(5)
    want = np.asarray(jgf.pow_const(jnp.asarray(a[:64]), e))
    np.testing.assert_array_equal(to_np(tgf.pow_const(to_t(a[:64]), e)), want)


@pytest.mark.parametrize("n", [1, 5, 64, 257])
def test_batch_inverse_and_prefix_product_match_jax(n):
    rng = np.random.default_rng(n)
    a = np.concatenate([BOUNDARY[1:], rand_words(rng, n)])[:n]
    a[a == 0] = 3
    np.testing.assert_array_equal(
        to_np(tgf.batch_inverse(to_t(a))), np.asarray(jgf.batch_inverse(jnp.asarray(a)))
    )
    np.testing.assert_array_equal(
        to_np(tgf.prefix_product(to_t(a))), np.asarray(jgf.prefix_product(jnp.asarray(a)))
    )


def test_modsum_matches_python():
    a, _ = _operands(6)
    assert int(to_np(tgf.modsum(to_t(a)))) == sum(int(v) for v in a) % P


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_extension_ops_match_jax(op):
    a, b = _operands(7)
    c, d = _operands(8)
    want = getattr(jext, op)((jnp.asarray(a), jnp.asarray(c)), (jnp.asarray(b), jnp.asarray(d)))
    got = getattr(text, op)((to_t(a), to_t(c)), (to_t(b), to_t(d)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))


def test_extension_batch_inverse_matches_jax():
    rng = np.random.default_rng(9)
    a, c = rand_words(rng, 100), rand_words(rng, 100)
    want = jext.batch_inverse((jnp.asarray(a), jnp.asarray(c)))
    got = text.batch_inverse((to_t(a), to_t(c)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))


def test_extension_host_scalars_match_jax():
    rng = np.random.default_rng(10)
    for _ in range(20):
        x = tuple(int(v) for v in rand_words(rng, 2))
        y = tuple(int(v) for v in rand_words(rng, 2))
        assert text.mul_s(x, y) == jext.mul_s(x, y)
        assert text.inv_s(x) == jext.inv_s(x)
        assert text.pow_s(x, 1000003) == jext.pow_s(x, 1000003)
        assert text.powers_s(x, 5) == jext.powers_s(x, 5)


def test_host_constants_and_tables_match_jax():
    from boojum_tpu.field import gl as jgl

    assert (tgl.P, tgl.MULTIPLICATIVE_GENERATOR, tgl.TWO_ADICITY) == (
        jgl.P, jgl.MULTIPLICATIVE_GENERATOR, jgl.TWO_ADICITY)
    for log_n in (1, 10, 20, 32):
        assert tgl.omega(log_n) == jgl.omega(log_n)
    np.testing.assert_array_equal(tgl.powers_np(tgl.omega(9), 512),
                                  jgl.powers_np(jgl.omega(9), 512))
