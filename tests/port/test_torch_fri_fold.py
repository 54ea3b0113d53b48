"""boojum_tpu_torch's FRI fold of one committed oracle (prover/fri.py
fold_oracle, kernel B7 on the card, its plain version here) against the
JAX package's fused k-fold of one schedule entry (boojum_tpu/prover/fri.py
_fri_fold_fn(k)) with the JAX package's per-round 1/x tables, word for word
(tolerance 0: the field arithmetic is exact); the squaring identity that
gives the later rounds' 1/x from the first round's; the tables fri_prove
caches. The kernel against its plain version on the card is in
test_torch_kernels.py, which imports no JAX."""

import jax.numpy as jnp
import numpy as np
import pytest

from boojum_tpu.prover import fri as jfri
from boojum_tpu_torch.field import goldilocks as gf
from boojum_tpu_torch.prover import fri as tfri
from torch_port_util import rand_words, to_np, to_t


@pytest.mark.parametrize("extra", [0, 1, None])
@pytest.mark.parametrize("R", [0, 2])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_fold_oracle_matches_jax_fused_fold(k, R, extra):
    """k rounds from round R over N = 2^(k + extra) points (N = 2^10 for
    None), against _fri_fold_fn(k) with rounds R .. R+k-1 of the JAX
    package's fold_challenge_tables."""
    log_n = 10 if extra is None else k + extra
    log_full = log_n + R
    rng = np.random.default_rng(100 * k + 10 * R + log_n)
    c0, c1 = rand_words(rng, 1 << log_n), rand_words(rng, 1 << log_n)
    ch = tuple(int(v) for v in rand_words(rng, 2))
    jtables = jfri.fold_challenge_tables(log_full, R + k)
    want = jfri._fri_fold_fn(k)(jnp.asarray(c0), jnp.asarray(c1),
                                jnp.asarray(np.array(ch, dtype=np.uint64)),
                                tuple(jtables[R:R + k]))
    inv_x0 = tfri.fold_challenge_tables(log_full, R + 1, "cpu")[R]
    got = tfri.fold_oracle(to_t(c0), to_t(c1), tfri.sub_challenges(ch, k), inv_x0)
    for g, w in zip(got, want):
        assert g.shape == (1 << (log_n - k),)
        np.testing.assert_array_equal(to_np(g), np.asarray(w))


def test_fold_oracle_matches_jax_pallas_fold():
    """One entry of 3 rounds against _fri_fold_fn(3, limb=True), which runs
    the Pallas fold kernel (pallas_sweep.fri_fold) in interpret mode here."""
    rng = np.random.default_rng(3)
    c0, c1 = rand_words(rng, 64), rand_words(rng, 64)
    ch = tuple(int(v) for v in rand_words(rng, 2))
    jtables = jfri.fold_challenge_tables(6, 3)
    want = jfri._fri_fold_fn(3, True)(jnp.asarray(c0), jnp.asarray(c1),
                                      jnp.asarray(np.array(ch, dtype=np.uint64)),
                                      tuple(jtables))
    got = tfri.fold_oracle(to_t(c0), to_t(c1), tfri.sub_challenges(ch, 3),
                           tfri.fold_challenge_tables(6, 1, "cpu")[0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))


@pytest.mark.parametrize("R", [0, 2])
@pytest.mark.parametrize("log_full", [6, 10])
def test_later_round_tables_are_squares(log_full, R):
    """t_{r+1}[m] = t_r[2m]^2: the tables derived from round R's equal the
    JAX package's tables of rounds R+1 .. R+4 (as far as the domain goes)."""
    rounds = min(5, log_full - R)
    jtables = jfri.fold_challenge_tables(log_full, R + rounds)
    t = tfri.fold_challenge_tables(log_full, R + 1, "cpu")[R]
    np.testing.assert_array_equal(to_np(t), np.asarray(jtables[R]))
    for j in range(1, rounds):
        t = gf.sqr(t[0::2])
        np.testing.assert_array_equal(to_np(t), np.asarray(jtables[R + j]))


@pytest.mark.parametrize("schedule", [[3, 3, 3, 1], [1], [2, 5, 1]])
def test_entry_tables_are_each_entry_first_round(schedule):
    """fri_prove's cached tables: the first round's 1/x of each entry."""
    log_full = sum(schedule) + 2
    got = tfri.fold_entry_tables(log_full, schedule, "cpu")
    every = tfri.fold_challenge_tables(log_full, sum(schedule), "cpu")
    firsts = np.cumsum([0] + schedule[:-1])
    assert len(got) == len(schedule)
    for t, r in zip(got, firsts):
        np.testing.assert_array_equal(to_np(t), to_np(every[r]))


def test_fold_oracle_equals_one_round_folds_at_extreme_words():
    """The fused rounds (no 1/2 a round, 2^-k at the end, squared tables)
    against k rounds of fold_once_plain, at 0, 1, p - 1 and p - 2^32 in
    values, table and challenge, and the challenge 0."""
    rng = np.random.default_rng(7)
    extreme = np.array([0, 1, gf.P - 1, gf.P - 2**32], dtype=np.uint64)
    N = 1 << 9
    words = [rand_words(rng, m) for m in (N, N, N // 2)]
    for w in words:
        pick = rng.random(w.shape[0]) < 0.5
        w[pick] = rng.choice(extreme, size=int(pick.sum()))
    c0, c1, inv_x0 = (to_t(w) for w in words)
    for ch in ((0, 0), (gf.P - 1, gf.P - 2**32), (1, 0)):
        subs = tfri.sub_challenges(ch, 5)
        t, a, b = inv_x0, c0, c1
        for r, sub in enumerate(subs):
            if r:
                t = gf.sqr(t[0::2])
            a, b = tfri.fold_once_plain(a, b, sub, t)
        got = tfri.fold_oracle(c0, c1, subs, inv_x0)
        np.testing.assert_array_equal(to_np(got[0]), to_np(a))
        np.testing.assert_array_equal(to_np(got[1]), to_np(b))


@pytest.mark.parametrize("N,k", [(8, 4), (12, 3), (8, 0)])
def test_fold_oracle_refuses_what_it_cannot_fold(N, k):
    rng = np.random.default_rng(N)
    c0, c1, inv = (to_t(rand_words(rng, m)) for m in (N, N, N // 2))
    with pytest.raises(ValueError):
        tfri.fold_oracle(c0, c1, tfri.sub_challenges((3, 5), k) if k else [], inv)
