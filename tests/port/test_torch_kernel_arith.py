"""The identities the redesigned CUDA kernels rely on, held on Python integers
and small tensors on the CPU, where no kernel runs.

Test-side models, used nowhere in the package:
- the Goldilocks primitives of csrc/goldilocks.cuh (the add and subtract
  carry chains, the reduction of a 96-bit accumulator with high word below
  2^32 and of a 128-bit product);
- the Poseidon2 internal layer as shifts into one accumulator and one
  reduction, the external layer as one small-coefficient combination per
  output, and the permutation with each layer adding the next round's
  constants and values left lazy in between (csrc/poseidon2.cu), against
  the plain versions of hashes/poseidon2.py;
- the lazy add and subtract of goldilocks.cuh, the small wide product,
  the accumulator of 128-bit products reduced once and the lazy GF(p^2)
  product the sweep (csrc/quotient_sweep.cu) runs on, and
  the scalar-table entries only that kernel reads;
- the forward NTT's pass plan (csrc/ntt.cu): which index bits each pass
  transforms and with which twiddles (ntt.py `_forward_tables`), composed
  and checked against `fft_plain`, and the tile layouts' bank spread;
- the inverse NTT's passes, the mirror (ntt.py `inverse_pass_plan`,
  `_inverse_tables`), composed and checked against `ifft_plain` and the
  JAX package's inverse, and its tile layouts' bank spread.
"""

import re

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from boojum_tpu_torch.field import goldilocks as gf
from boojum_tpu_torch.hashes import poseidon2 as p2
from boojum_tpu_torch.hashes import poseidon2_params as params
from boojum_tpu_torch.ntt import ntt
from torch_port_util import BOUNDARY, REPO

P = gf.P
EPS = (1 << 32) - 1
M64 = (1 << 64) - 1
WORDS = st.integers(0, M64)
CANONICAL = st.integers(0, P - 1)
EDGE = [int(v) for v in BOUNDARY] + [M64, P, P + 1, 1 << 63]


# -- reductions (goldilocks.cuh) ---------------------------------------------


def reduce_w_lazy(w: int) -> int:
    """reduce_w_lazy: w = lo + w2 * 2^64 (w2 < 2^32) as lo + w2 * eps, one
    carry fix-up."""
    lo, w2 = w & M64, w >> 64
    assert w2 < 1 << 32
    s = lo + w2 * EPS
    if s > M64:
        s = (s & M64) + EPS
    assert s <= M64
    return s


def reduce_w(w: int) -> int:
    s = reduce_w_lazy(w)
    return s - P if s >= P else s


def reduce128_lazy(hi: int, lo: int) -> int:
    hh, hl = hi >> 32, hi & EPS
    t0 = (lo - hh) & M64
    if lo < hh:
        t0 = (t0 - EPS) & M64
    t2 = t0 + hl * EPS
    if t2 > M64:
        t2 = (t2 & M64) + EPS
    assert t2 <= M64
    return t2


def add_canonical(a: int, b: int) -> int:
    """gl::add: the carry chain, then eps once on a carry or a sum in
    [p, 2^64)."""
    s, c = (a + b) & M64, (a + b) >> 64
    wrap = c or (s >> 32 == EPS and s & EPS != 0)
    return (s + (EPS if wrap else 0)) & M64


def sub_canonical(a: int, b: int) -> int:
    """gl::sub: on a borrow add p (the borrow mask's low bit and the mask)."""
    d, bw = (a - b) & M64, EPS if a < b else 0
    return (d + ((bw << 32) | (bw & 1))) & M64


@settings(max_examples=400, deadline=None)
@given(CANONICAL, CANONICAL)
@example(P - 1, P - 1)
@example(P - 1, 1)
@example(P - 1, 0)
@example(0, P - 1)
@example(EPS, P - EPS)
@example(1 << 63, 1 << 63)
def test_add_and_sub_carry_chains(a, b):
    assert add_canonical(a, b) == (a + b) % P
    assert sub_canonical(a, b) == (a - b) % P


@settings(max_examples=400, deadline=None)
@given(st.integers(0, EPS), WORDS)
@example(EPS, M64)
@example(EPS, 0)
@example(0, M64)
@example(1, P - 1)
def test_reduce_of_a_hi_lo_pair(hi, lo):
    w = (hi << 64) | lo
    assert reduce_w(w) == w % P
    assert reduce_w_lazy(w) % P == w % P


@settings(max_examples=400, deadline=None)
@given(WORDS, WORDS)
@example(M64, M64)
@example(P - 1, P - 1)
@example(M64, 0)
def test_lazy_product(a, b):
    prod = a * b
    assert reduce128_lazy(prod >> 64, prod & M64) % P == prod % P


def add_lazy(a: int, b: int) -> int:
    """gl::add_lazy: a carry puts eps back, at most twice."""
    s = a + b
    if s > M64:
        s = (s & M64) + EPS
        if s > M64:
            s = (s & M64) + EPS
    assert s <= M64
    return s


def sub_lazy(a: int, b: int) -> int:
    """gl::sub_lazy: a borrow takes eps off, at most twice."""
    d = (a - b) & M64
    if a < b:
        e = (d - EPS) & M64
        d = (e - EPS) & M64 if d < EPS else e
    return d


def wmul32(a: int, c: int) -> int:
    """gl::wmul32: a * c as lo + hi * 2^32, in 96 bits."""
    lo = (a & EPS) * c
    mid = (lo >> 32) + (a >> 32) * c
    assert mid <= M64
    return (mid << 32) | (lo & EPS)


def mul_lazy(a: int, b: int) -> int:
    prod = a * b
    return reduce128_lazy(prod >> 64, prod & M64)


def reduce_acc_lazy(x: int) -> int:
    """gl::reduce_acc_lazy: an accumulator lo + hi 2^64 + k 2^128 (k < 2^31
    carries) as reduce128_lazy with k added to hi's top half (2^128 =
    -2^32)."""
    lo, hi, k = x & M64, (x >> 64) & M64, x >> 128
    assert k < 1 << 31
    hh, hl = (hi >> 32) + (k << 32), hi & EPS
    t0 = (lo - hh) & M64
    if lo < hh:
        assert t0 > EPS
        t0 -= EPS
    t2 = t0 + hl * EPS
    if t2 > M64:
        t2 = (t2 & M64) + EPS
    assert t2 <= M64
    return t2


def ext_mul_lazy(a, b):
    """gl::ext_mul_lazy: c1 the two 128-bit products summed and reduced
    once; c0 the 128-bit a0 b0 plus 7 times the lazy a1 b1."""
    c0 = reduce_acc_lazy(a[0] * b[0] + wmul32(mul_lazy(a[1], b[1]), 7))
    return c0, reduce_acc_lazy(a[0] * b[1] + a[1] * b[0])


@settings(max_examples=400, deadline=None)
@given(WORDS, WORDS)
@example(M64, M64)
@example(M64, 1)
@example(0, M64)
@example(P - 1, M64)
@example(EPS, M64)
def test_lazy_add_and_sub_take_any_words(a, b):
    assert add_lazy(a, b) % P == (a + b) % P
    assert sub_lazy(a, b) % P == (a - b) % P
    assert 0 <= sub_lazy(a, b) <= M64


@settings(max_examples=400, deadline=None)
@given(WORDS, WORDS, WORDS, WORDS)
@example(M64, M64, M64, M64)
@example(P - 1, P - 1, P - 1, P - 1)
@example(M64, M64, M64, 0)
@example(M64, 0, M64, M64)
@example(0, 1, 0, 1)
def test_lazy_ext_product(a0, a1, b0, b1):
    assert wmul32(a1, 7) == 7 * a1
    c0, c1 = ext_mul_lazy((a0, a1), (b0, b1))
    assert c0 % P == (a0 * b0 + 7 * a1 * b1) % P
    assert c1 % P == (a0 * b1 + a1 * b0) % P


@settings(max_examples=100, deadline=None)
@given(st.lists(st.tuples(WORDS, WORDS), min_size=1, max_size=300))
@example([(M64, M64)] * 300)
@example([(P - 1, P - 1)] * 2)
def test_product_accumulator(pairs):
    """gl::Acc: 128-bit products summed with their carries, reduced once
    (the sweep's sums of products); the words stay below 2^64."""
    total = sum(a * b for a, b in pairs)
    r = reduce_acc_lazy(total)
    assert r <= M64 and r % P == total % P


def test_sweep_kernel_entries_of_the_scalar_table():
    """The entries after the plain version's: (beta.c0 k_i, beta.c1 k_i)
    per copy column, then 7 alpha^t.c1 per alpha power."""
    from boojum_tpu_torch.circuits import build_general_lookup
    from boojum_tpu_torch.field import extension as ext_f
    from boojum_tpu_torch.prover import quotient_sweep as qs
    from boojum_tpu_torch.prover.setup import build_selector_tree

    asm = build_general_lookup()[0].into_assembly()
    _tree, paths = build_selector_tree(asm.gates)
    Ct = asm.num_copy_cols_total
    plan = qs.SweepPlan(asm.gates, paths, asm.geometry, Ct, "cpu", asm.lookup_params)
    alpha, beta, ks = (P - 3, 5), (P - 7, 11), [P - 1 - i for i in range(Ct)]
    table = [int(v) for v in gf.to_numpy(
        qs.sweep_table(plan, alpha, beta, (13, 17), ks, "cpu", (19, 23), (29, 31)))]
    assert len(table) == plan.table_len
    tail = table[plan.table_len - 2 * Ct - plan.num_alpha:]
    assert tail[:2 * Ct] == [b * k % P for k in ks for b in beta]
    pows = ext_f.powers_s(alpha, plan.num_alpha)
    assert tail[2 * Ct:] == [7 * a1 % P for _a0, a1 in pows]
    assert table[4 + Ct + plan.num_alpha:4 + Ct + 2 * plan.num_alpha] == [a1 for _a0, a1 in pows]


# -- Poseidon2 layers (poseidon2.cu) -----------------------------------------

M4 = [[5, 7, 1, 3], [4, 6, 1, 1], [1, 3, 5, 7], [1, 1, 4, 6]]
# circ(2*M4, M4, M4): the coefficient of input j in output i
EXTERNAL = [[M4[i % 4][j % 4] * (2 if i // 4 == j // 4 else 1) for j in range(12)]
            for i in range(12)]


def _source_diag_log() -> list[int]:
    src = (REPO / "boojum_tpu_torch" / "csrc" / "poseidon2.cu").read_text()
    m = re.search(r"kDiagLog\[12\] = \{([^}]*)\}", src)
    return [int(v) for v in m.group(1).split(",")]


DIAG_LOG = _source_diag_log()


def test_baked_diagonal_is_the_parameters():
    assert [1 << d for d in DIAG_LOG] == [int(v) for v in params.M_I_DIAGONAL]


def internal_model(s: list[int], rc=None, canonical=False) -> list[int]:
    """Shifts into one wide sum a word, each reduced once (rc: the next
    round's constants, added before the reduction)."""
    total = sum(s)
    out = []
    for i, v in enumerate(s):
        w = (v << DIAG_LOG[i]) + total + (rc[i] if rc else 0)
        assert w < (1 << 78) + 13 * (1 << 64)
        out.append(reduce_w(w) if canonical else reduce_w_lazy(w))
    return out


def external_model(s: list[int], rc=None, canonical=False) -> list[int]:
    out = []
    for i in range(12):
        w = sum(c * v for c, v in zip(EXTERNAL[i], s)) + (rc[i] if rc else 0)
        assert w < 1 << 71
        out.append(reduce_w(w) if canonical else reduce_w_lazy(w))
    return out


def _as_tensors(s):
    return [gf.from_numpy(np.array([v], dtype=np.uint64)) for v in s]


def _ints(ts):
    return [int(gf.to_numpy(t)[0]) for t in ts]


STATES = st.lists(st.sampled_from(EDGE[:9]) | CANONICAL, min_size=12, max_size=12)
LAZY_STATES = st.lists(st.sampled_from(EDGE) | WORDS, min_size=12, max_size=12)


@settings(max_examples=60, deadline=None)
@given(STATES)
@example([P - 1] * 12)
@example([0] * 12)
@example([(1 << 63) + i for i in range(12)])
def test_internal_layer_as_shifts(s):
    assert internal_model(s, canonical=True) == _ints(p2._internal_mds(_as_tensors(s)))


@settings(max_examples=60, deadline=None)
@given(STATES)
@example([P - 1] * 12)
@example([0] * 12)
@example([(1 << 63) + i for i in range(12)])
def test_external_layer_as_one_combination(s):
    assert external_model(s, canonical=True) == _ints(p2._external_mds(_as_tensors(s)))


@settings(max_examples=200, deadline=None)
@given(LAZY_STATES)
@example([M64] * 12)
def test_layers_take_lazy_words(s):
    """Inputs anywhere below 2^64 (the lazy words the kernel passes on):
    the accumulators stay in bounds and the outputs are congruent."""
    total = sum(s)
    want_int = [(v * (1 << d) + total) % P for v, d in zip(s, DIAG_LOG)]
    assert [v % P for v in internal_model(s)] == want_int
    want_ext = [sum(c * v for c, v in zip(row, s)) % P for row in EXTERNAL]
    assert [v % P for v in external_model(s)] == want_ext


def sbox_lazy(x: int) -> int:
    def mul(a, b):
        prod = a * b
        return reduce128_lazy(prod >> 64, prod & M64)

    x2 = mul(x, x)
    x3 = mul(x2, x)
    return mul(mul(x2, x2), x3)


def permute_model(s: list[int]) -> list[int]:
    """csrc/poseidon2.cu permute: each linear layer adds the next round's
    constants before its one reduction; values lazy until the last layer."""
    rc = p2.RC

    def lane0(r):
        return [rc[r][0]] + [0] * 11

    s = external_model(s, rc[0])
    for r in range(4):
        s = [sbox_lazy(v) for v in s]
        s = external_model(s, rc[r + 1] if r < 3 else lane0(4))
    for r in range(4, 26):
        s[0] = sbox_lazy(s[0])
        s = internal_model(s, lane0(r + 1) if r < 25 else rc[26])
    for r in range(26, 30):
        s = [sbox_lazy(v) for v in s]
        s = external_model(s, rc[r + 1] if r < 29 else None, canonical=r == 29)
    return s


@settings(max_examples=12, deadline=None)
@given(STATES)
@example([P - 1] * 12)
@example([0] * 12)
def test_permutation_with_folded_constants(s):
    assert permute_model(s) == p2.poseidon2_permutation_host(s)


# -- the forward NTT's passes (ntt.cu) ---------------------------------------


@pytest.mark.parametrize("log_n", range(1, 32))
def test_pass_plan_limits(log_n):
    plan = ntt.forward_pass_plan(log_n)
    assert sum(plan) == log_n and min(plan) >= 1
    assert plan[-1] <= ntt.MAX_LAST_PASS
    lo = log_n
    for k in plan[:-1]:
        lo -= k
        assert k <= ntt.MAX_STRIDED_PASS and lo >= 3  # 8 adjacent columns a tile
    assert len(plan) == (1 if log_n <= 11 else 2 if log_n <= 21 else 3)
    if log_n == 20:
        assert plan == (9, 11)


def compose_passes(a: torch.Tensor, log_n: int) -> torch.Tensor:
    """The kernel's passes on (B, n) rows: pass (lo, k) runs DIF stages on
    index bits lo + k - 1 .. lo of every 2^(lo + k) block, the pair (i0,
    i0 + 2^b) of position bit b taking heap[2^(k-1) + ((i0 mod 2^b) << (k -
    1 - b))], then (strided) multiplies the block by its post table."""
    plan, heap, post = ntt._forward_tables(log_n, "cpu")
    B, n = a.shape
    x, lo, used = a, log_n, 0
    for k in plan:
        lo -= k
        v = x.reshape(B, -1, 1 << k, 1 << lo)
        for b in range(k - 1, -1, -1):
            h = 1 << b
            v = v.reshape(B, v.shape[1], -1, 2, h, 1 << lo)
            u, w = v[:, :, :, 0], v[:, :, :, 1]
            tw = heap[(1 << (k - 1)) + (torch.arange(h) << (k - 1 - b))]
            v = torch.stack([gf.add(u, w), gf.mul(gf.sub(u, w), tw[:, None])], dim=3)
        v = v.reshape(B, -1, 1 << (lo + k))
        if lo:
            m = 1 << (lo + k)
            v = gf.mul(v, post[used:used + m])
            used += m
        x = v.reshape(B, n)
    assert used == (post.numel() if len(plan) > 1 else 0)
    return x


@pytest.mark.parametrize("log_n", range(1, 15))
def test_pass_plan_composes_to_the_transform(log_n):
    rng = np.random.default_rng(log_n)
    a = gf.from_numpy(rng.integers(0, P, size=(2, 1 << log_n), dtype=np.uint64))
    assert torch.equal(compose_passes(a, log_n), ntt.fft_plain(a))


def _swz(i):
    return i ^ ((i >> 3) & 15)


@pytest.mark.parametrize("k,strided", [(k, True) for k in range(6, 11)]
                         + [(k, False) for k in range(6, 12)])
def test_tile_exchanges_spread_over_the_banks(k, strided):
    """Every shared-memory exchange of a pass of k >= 6 bits (every pass of
    a plan above 2^11): the 16 threads of a half-warp touch 16 different
    8-byte bank pairs, and the swizzle is a bijection on the tile."""
    tb = 3 if strided else 0
    s_bits = k + (3 if strided else max(0, 11 - k))
    idx = np.arange(1 << s_bits)
    assert np.array_equal(np.sort(_swz(idx)), idx)
    first = k % 3 or 3
    rounds = [(k - first, first)] + [(c, 3) for c in range(k - first - 3, -1, -3)]
    threads = (1 << s_bits) // 8
    for c, rb in rounds:
        lo = tb + c
        for j in range(8 >> rb):
            u = np.arange(threads) + j * threads
            for e in range(1 << rb):
                i = (u & ((1 << lo) - 1)) | (e << lo) | ((u >> lo) << (lo + rb))
                slots = (_swz(i) % 16).reshape(-1, 16)
                assert all(len(set(h)) == 16 for h in slots), (c, rb, j, e)


# -- the inverse NTT's passes (ntt.cu) ---------------------------------------


@pytest.mark.parametrize("log_n", range(1, 32))
def test_inverse_pass_plan_limits(log_n):
    plan = ntt.inverse_pass_plan(log_n)
    assert sum(plan) == log_n and min(plan) >= 1
    assert plan[0] <= ntt.MAX_LAST_PASS  # the contiguous pass, on the low bits
    lo = plan[0]
    for k in plan[1:]:
        assert k <= ntt.MAX_STRIDED_PASS and lo >= 3  # 8 adjacent columns a tile
        lo += k
    assert len(plan) == (1 if log_n <= 11 else 2 if log_n <= 21 else 3)
    if log_n == 20:
        assert plan == (11, 9)


def compose_inverse_passes(a: torch.Tensor, log_n: int) -> torch.Tensor:
    """The inverse kernel's passes on (B, n) rows: pass (lo, k) multiplies
    every 2^(lo + k) block by its pre table (strided), then runs DIT stages
    on index bits lo .. lo + k - 1, the pair (i0, i0 + 2^b) of position bit b
    multiplying its odd element by heap[2^(k-1) + ((i0 mod 2^b) << (k - 1 -
    b))]; a single pass multiplies by 1/n at its store."""
    plan, heap, pre, _c_plan, _n_inv = ntt._inverse_tables(log_n, "cpu")
    B, n = a.shape
    x, lo, used = a, 0, 0
    for k in plan:
        v = x.reshape(B, -1, 1 << (lo + k))
        if lo:
            m = 1 << (lo + k)
            v = gf.mul(v, pre[used:used + m])
            used += m
        v = v.reshape(B, -1, 1 << k, 1 << lo)
        for b in range(k):
            h = 1 << b
            v = v.reshape(B, v.shape[1], -1, 2, h, 1 << lo)
            u, w = v[:, :, :, 0], v[:, :, :, 1]
            tw = heap[(1 << (k - 1)) + (torch.arange(h) << (k - 1 - b))]
            w = gf.mul(w, tw[:, None])
            v = torch.stack([gf.add(u, w), gf.sub(u, w)], dim=3)
        x = v.reshape(B, n)
        lo += k
    assert used == (pre.numel() if len(plan) > 1 else 0)
    if len(plan) == 1:
        x = gf.mul(x, ntt.get_ntt_context(log_n, "cpu").n_inv)
    return x


@pytest.mark.parametrize("log_n", range(1, 15))
def test_inverse_passes_compose_to_the_transform(log_n):
    rng = np.random.default_rng(50 + log_n)
    a = gf.from_numpy(rng.integers(0, P, size=(2, 1 << log_n), dtype=np.uint64))
    assert torch.equal(compose_inverse_passes(a, log_n), ntt.ifft_plain(a))


@pytest.mark.parametrize("log_n", [5, 12, 13])
def test_inverse_passes_match_the_jax_inverse(log_n):
    jnp = pytest.importorskip("jax.numpy")
    from boojum_tpu.ntt import ntt as jntt

    rng = np.random.default_rng(70 + log_n)
    words = rng.integers(0, P, size=(2, 1 << log_n), dtype=np.uint64)
    want = np.asarray(jntt.ifft_bitreversed_to_natural_xla(jnp.asarray(words)))
    got = compose_inverse_passes(gf.from_numpy(words), log_n)
    np.testing.assert_array_equal(gf.to_numpy(got), want)


@pytest.mark.parametrize("k,strided", [(k, True) for k in range(6, 11)]
                         + [(k, False) for k in range(6, 12)])
def test_inverse_tile_exchanges_spread_over_the_banks(k, strided):
    """The inverse's rounds, bottom up ((0, 3), (3, 3), ..., the rest last)
    on the forward's tile layouts: at every exchange the 16 threads of a
    half-warp touch 16 different 8-byte bank pairs."""
    tb = 3 if strided else 0
    s_bits = k + (3 if strided else max(0, 11 - k))
    threads = (1 << s_bits) // 8
    rounds, c = [], 0
    while c < k:
        rounds.append((c, min(3, k - c)))
        c += 3
    first = k % 3 or 3
    assert rounds[-1] == (k - first, first)  # the forward's first round
    for c, rb in rounds:
        lo = tb + c
        for j in range(8 >> rb):
            u = np.arange(threads) + j * threads
            for e in range(1 << rb):
                i = (u & ((1 << lo) - 1)) | (e << lo) | ((u >> lo) << (lo + rb))
                slots = (_swz(i) % 16).reshape(-1, 16)
                assert all(len(set(h)) == 16 for h in slots), (c, rb, j, e)
