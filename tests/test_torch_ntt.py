"""boojum_tpu_torch NTT / LDE (plain versions of kernels B1-B3) against the
JAX package's XLA transforms, word for word."""

import jax.numpy as jnp
import numpy as np
import pytest

from boojum_tpu.field import gl as jgl
from boojum_tpu.field import goldilocks as jgf
from boojum_tpu.ntt import ntt as jntt
from boojum_tpu_torch.ntt import ntt as tntt
from torch_port_util import rand_words, to_np, to_t


@pytest.mark.parametrize("log_n", [1, 3, 8, 11, 12])
def test_forward_matches_jax(log_n):
    a = rand_words(np.random.default_rng(log_n), 3, 1 << log_n)
    want = np.asarray(jntt.fft_natural_to_bitreversed_xla(jnp.asarray(a)))
    np.testing.assert_array_equal(to_np(tntt.fft_natural_to_bitreversed(to_t(a))), want)


@pytest.mark.parametrize("log_n", [1, 3, 8, 11, 12])
def test_inverse_matches_jax(log_n):
    a = rand_words(np.random.default_rng(100 + log_n), 3, 1 << log_n)
    want = np.asarray(jntt.ifft_bitreversed_to_natural_xla(jnp.asarray(a)))
    np.testing.assert_array_equal(to_np(tntt.ifft_bitreversed_to_natural(to_t(a))), want)


@pytest.mark.parametrize("log_n,lde", [(4, 2), (8, 4), (10, 8)])
def test_lde_matches_jax(log_n, lde):
    a = rand_words(np.random.default_rng(log_n * lde), 5, 1 << log_n)
    want = np.asarray(jntt.lde_from_monomial(jnp.asarray(a), lde))
    got = tntt.lde_from_monomial(to_t(a), lde)
    assert tuple(got.shape) == (5, lde, 1 << log_n)
    np.testing.assert_array_equal(to_np(got), want)


def test_scale_rows_and_coset_eval_match_jax():
    log_n, Q = 8, 4
    want = np.asarray(jntt.lde_scale_rows(log_n, Q))
    got = tntt.lde_scale_rows(log_n, Q, "cpu")
    np.testing.assert_array_equal(to_np(got), want)
    a = rand_words(np.random.default_rng(3), 4, 1 << log_n)
    want_eval = np.asarray(jntt.fft_natural_to_bitreversed_xla(
        jgf.mul(jnp.asarray(a), jnp.asarray(want[2]))
    ))
    np.testing.assert_array_equal(
        to_np(tntt.fft_natural_to_bitreversed(to_t(a), got[2])), want_eval
    )


def test_monomial_from_values_and_distribute_powers_match_jax():
    a = rand_words(np.random.default_rng(5), 6, 256)
    np.testing.assert_array_equal(
        to_np(tntt.monomial_from_values(to_t(a))),
        np.asarray(jntt.monomial_from_values(jnp.asarray(a))),
    )
    np.testing.assert_array_equal(
        to_np(tntt.distribute_powers(to_t(a), 12345)),
        np.asarray(jntt.distribute_powers(jnp.asarray(a), 12345)),
    )


def test_eval_at_ext_point_matches_jax():
    rng = np.random.default_rng(6)
    a = rand_words(rng, 7, 256)
    z = tuple(int(v) for v in rand_words(rng, 2))
    want = jntt.eval_monomial_at_ext_point(jnp.asarray(a), z)
    got = tntt.eval_monomial_at_ext_point(to_t(a), z)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))


def test_bitreverse_and_twiddles_match_jax():
    for log_n in (1, 5, 10):
        np.testing.assert_array_equal(
            tntt.bitreverse_indices(log_n).numpy(), jntt.bitreverse_indices(log_n)
        )
    ctx = tntt.get_ntt_context(10, "cpu")
    np.testing.assert_array_equal(to_np(ctx.tw), jgl.powers_np(jgl.omega(10), 512))
