"""FRI: commit-and-fold low-degree test over GF(p^2).

The codeword is an ext pair over the full LDE domain in bit-reversed order,
so fold pairs (x, -x) are adjacent. Each committed oracle groups 2^k
consecutive points (its whole fold subtree) per Merkle leaf, interleaving
(c0, c1) per point, and answers k fold rounds with one drawn challenge and
its squares. The k rounds of one oracle are kernel B7 (csrc/fri_fold.cu, one
launch; it replaces boojum_tpu/prover/pallas_sweep.py _fold_body, composed k
times by boojum_tpu/prover/fri.py _fri_fold_fn).
"""

from __future__ import annotations

from functools import lru_cache
from itertools import accumulate

import torch

from .. import kernels as K
from ..field import extension as ext_f
from ..field import gl
from ..field import goldilocks as gf
from ..merkle import MerkleTreeWithCap
from ..ntt import distribute_powers, ifft_bitreversed_to_natural
from ..ntt.ntt import bitreverse_indices

# the most rounds one launch of csrc/fri_fold.cu folds (its kMaxK), the
# longest entry fold_schedule gives: a thread holds 2^MAX_FOLD_K points of
# each component in registers
MAX_FOLD_K = 3


def _round_table(log_full: int, r: int, device: str) -> torch.Tensor:
    """1/x over the round-r domain g^(2^r)·<w_{N>>r}> at the pair positions
    (even bit-reversed indices)."""
    log_nr = log_full - r
    shift_inv = gl.inv(gl.pow_(gl.MULTIPLICATIVE_GENERATOR, 1 << r))
    inv_nat = gf.mul(gf.powers(gl.inv(gl.omega(log_nr)), 1 << log_nr, device), shift_inv)
    return inv_nat[bitreverse_indices(log_nr, device)[0::2]]


def fold_challenge_tables(log_full: int, num_rounds: int, device) -> list:
    """Per-round 1/x at the pair positions, rounds 0 .. num_rounds - 1."""
    dev = str(torch.device(device))
    return [_round_table(log_full, r, dev) for r in range(num_rounds)]


@lru_cache(maxsize=4)
def _entry_tables(log_full: int, schedule: tuple, device: str):
    firsts = accumulate(schedule[:-1], initial=0)
    return [_round_table(log_full, r, device) for r in firsts]


def fold_entry_tables(log_full: int, schedule, device) -> list:
    """The first round's 1/x of each schedule entry, cached: fold_oracle
    squares its way to the entry's later rounds (N/2 + N/16 + ... words for
    3-round entries, where every round's table would take N)."""
    return _entry_tables(log_full, tuple(schedule), str(torch.device(device)))


def sub_challenges(ch, k: int) -> list:
    """ch, ch^2, ch^4, ...: the sub-challenges of an oracle's k rounds."""
    subs = [ch]
    while len(subs) < k:
        subs.append(ext_f.sqr_s(subs[-1]))
    return subs


def _fold_sum(c0, c1, ch, inv_x):
    """One fold round without its 1/2: (f(x)+f(-x)) + ch·(f(x)-f(-x))/x."""
    a = (c0[0::2], c1[0::2])
    b = (c0[1::2], c1[1::2])
    s = ext_f.add(a, b)
    d_over_x = ext_f.mul_by_base(ext_f.sub(a, b), inv_x)
    return ext_f.add(s, ext_f.mul(d_over_x, (int(ch[0]), int(ch[1]))))


def fold_once_plain(c0, c1, ch, inv_x):
    t = _fold_sum(c0, c1, ch, inv_x)
    return gf.mul(t[0], gl.HALF), gf.mul(t[1], gl.HALF)


def fold_oracle_plain(c0, c1, subs, inv_x0):
    """The k = len(subs) rounds of fold_oracle as the kernel runs them: each
    round without its 1/2, round r + 1's 1/x the square of every other word
    of round r's, and one product by 2^-k at the end (the fold is linear in
    the values, so the words equal k rounds of fold_once_plain)."""
    t = inv_x0
    for r, ch in enumerate(subs):
        if r:
            t = gf.sqr(t[0::2])
        c0, c1 = _fold_sum(c0, c1, ch, t)
    scale = gl.pow_(gl.HALF, len(subs))
    return gf.mul(c0, scale), gf.mul(c1, scale)


def fold_oracle(c0: torch.Tensor, c1: torch.Tensor, subs, inv_x0: torch.Tensor):
    """k = len(subs) fold rounds of one committed oracle, f'(x^2) =
    (f(x)+f(-x))/2 + ch·(f(x)-f(-x))/(2x) with round r's sub-challenge
    subs[r], over a bit-reversed codeword (c0, c1) of N words (a multiple of
    2^k; a power of two in the prover); inv_x0 is 1/x of the first round at
    its N/2 pairs. Returns N/2^k words of each component (kernel B7: one
    launch up to MAX_FOLD_K rounds, then one a further MAX_FOLD_K)."""
    N = c0.shape[0]
    k = len(subs)
    K.require(c0, "fold c0", (N,))
    K.require(c1, "fold c1", (N,))
    K.require(inv_x0, "fold 1/x", (N // 2,))
    if k < 1 or N < 1 << k or N % (1 << k):
        raise ValueError(f"cannot fold {N} points {k} times")
    dev = K.same_device(c0, c1, inv_x0)
    if dev.type == "cpu":
        return fold_oracle_plain(c0, c1, subs, inv_x0)
    # the kernel loads 16 bytes at a time: a view at an odd word offset is copied
    c0, c1, inv_x0 = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (c0, c1, inv_x0))
    lib = K.library("fri_fold")
    done = 0
    with torch.cuda.device(dev):
        while done < k:
            kc = min(MAX_FOLD_K, k - done)
            n_out = N >> (done + kc)
            o0 = torch.empty(n_out, dtype=torch.int64, device=dev)
            o1 = torch.empty(n_out, dtype=torch.int64, device=dev)
            words = K.u64_array([w for ch in subs[done:done + kc]
                                 for w in (int(ch[0]), int(ch[1]), gl.mul(7, int(ch[1])))])
            K.count("fri_fold")
            K.check(
                lib.bt_fri_fold_oracle(
                    K.ptr(c0), K.ptr(c1), n_out, kc, K.ptr(inv_x0), done, words,
                    gl.pow_(gl.HALF, kc), K.ptr(o0), K.ptr(o1), K.stream(dev),
                ),
                "fri_fold",
            )
            c0, c1, done = o0, o1, done + kc
    return c0, c1


def fold_once(c0: torch.Tensor, c1: torch.Tensor, ch, inv_x: torch.Tensor):
    """One fold round (fold_oracle with one sub-challenge): a bit-reversed
    codeword (c0, c1) of length N to N/2 (kernel B7)."""
    return fold_oracle(c0, c1, [ch], inv_x)


def fold_schedule(base_degree: int, final_degree: int, explicit=None) -> list[int]:
    """Per-oracle fold counts: `explicit` where given (it must fold to
    final_degree), else greedy 3s, then the remainder."""
    num = 0
    deg = base_degree
    while deg > final_degree:
        deg //= 2
        num += 1
    if num < 1:
        raise ValueError("nothing to fold; lower fri_final_degree")
    if explicit is not None:
        explicit = [int(k) for k in explicit]
        if sum(explicit) != num or not all(k >= 1 for k in explicit):
            raise ValueError(f"folding schedule {explicit} must sum to {num}")
        return explicit
    out = []
    rem = num
    while rem > 3:
        out.append(3)
        rem -= 3
    out.append(rem)
    return out


def commit_codeword(c0, c1, cap_size: int, k: int) -> MerkleTreeWithCap:
    """Commit with 2^k points per leaf, leaf words (c0, c1) per point."""
    block = 1 << k
    n_leaves = c0.shape[0] >> k
    cols = torch.stack([c0.view(n_leaves, block), c1.view(n_leaves, block)], dim=2)
    return MerkleTreeWithCap.from_columns(
        cols.reshape(n_leaves, 2 * block).T.contiguous(), cap_size
    )


class FriOracles:
    def __init__(self):
        self.trees: list[MerkleTreeWithCap] = []
        self.values: list = []  # ext pair per committed oracle (device)
        self.challenges: list = []
        self.schedule: list[int] = []
        self.final_monomials = None  # host list of (c0, c1)


def fri_prove(codeword, transcript, config, base_degree: int, checkpoint) -> FriOracles:
    """Per schedule entry k: commit the codeword with 2^k points per leaf,
    absorb the cap, draw one challenge, fold k times with ch, ch^2, ch^4...
    in one call of fold_oracle.
    Then interpolate the final monomials and absorb them."""
    out = FriOracles()
    c0, c1 = codeword
    dev = c0.device
    N = c0.shape[0]
    log_full = N.bit_length() - 1
    schedule = fold_schedule(base_degree, config.fri_final_degree,
                             config.fri_folding_schedule)
    out.schedule = schedule
    num_folds = sum(schedule)
    tables = fold_entry_tables(log_full, schedule, dev)
    for r, k in enumerate(schedule):
        tree = commit_codeword(c0, c1, config.merkle_tree_cap_size, k)
        out.trees.append(tree)
        out.values.append((c0, c1))
        transcript.witness_merkle_tree_cap(tree.get_cap())
        checkpoint(5, f"fri_cap_{r}", tree.get_cap())
        ch = transcript.get_ext_challenge()
        checkpoint(5, f"fri_challenge_{r}", ch)
        out.challenges.append(ch)
        c0, c1 = fold_oracle(c0, c1, sub_challenges(ch, k), tables[r])
    # final interpolation over the coset g^(2^R)·H_{N>>R}
    shift_inv = gl.inv(gl.pow_(gl.MULTIPLICATIVE_GENERATOR, 1 << num_folds))
    m0 = gf.to_numpy(distribute_powers(ifft_bitreversed_to_natural(c0), shift_inv))
    m1 = gf.to_numpy(distribute_powers(ifft_bitreversed_to_natural(c1), shift_inv))
    deg_bound = base_degree >> num_folds
    if (m0[deg_bound:] != 0).any() or (m1[deg_bound:] != 0).any():
        raise RuntimeError("final FRI polynomial exceeds its degree bound")
    out.final_monomials = [(int(a), int(b)) for a, b in zip(m0[:deg_bound], m1[:deg_bound])]
    for a, b in out.final_monomials:
        transcript.witness_field_elements([a, b])
    checkpoint(5, "fri_final_monomials", out.final_monomials)
    return out


def _brev(i: int, bits: int) -> int:
    out = 0
    for b in range(bits):
        out |= ((i >> b) & 1) << (bits - 1 - b)
    return out


def fri_verify_queries(schedule, challenges, final_monomials, query_index: int,
                       leaves, log_full: int) -> bool:
    """Check one query's grouped fold chain on the host (python ints);
    leaves[r] holds the 2^k ext values of oracle r's leaf."""
    idx = query_index
    fold_round = 0
    cur_expected = None
    for r, k in enumerate(schedule):
        block = 1 << k
        sub_idx = idx % block
        leaf_idx = idx >> k
        vals = [tuple(v) for v in leaves[r]]
        if len(vals) != block:
            return False
        if cur_expected is not None and vals[sub_idx] != tuple(cur_expected):
            return False
        ch = challenges[r]
        base_global = leaf_idx * block
        for j in range(k):
            log_nr = log_full - fold_round
            shift = gl.pow_(gl.MULTIPLICATIVE_GENERATOR, 1 << fold_round)
            nxt = []
            for m in range(len(vals) // 2):
                gi = (base_global >> j) + 2 * m
                x = gl.mul(shift, gl.pow_(gl.omega(log_nr), _brev(gi, log_nr)))
                even, odd = vals[2 * m], vals[2 * m + 1]
                s = ext_f.add_s(even, odd)
                dox = ext_f.mul_by_base_s(ext_f.sub_s(even, odd), gl.inv(x))
                t = ext_f.add_s(s, ext_f.mul_s(dox, ch))
                nxt.append(ext_f.mul_by_base_s(t, gl.HALF))
            vals = nxt
            fold_round += 1
            ch = ext_f.sqr_s(ch)
        cur_expected = vals[0]
        idx = leaf_idx
    num_folds = sum(schedule)
    log_fin = log_full - num_folds
    shift = gl.pow_(gl.MULTIPLICATIVE_GENERATOR, 1 << num_folds)
    x = gl.mul(shift, gl.pow_(gl.omega(log_fin), _brev(idx, log_fin)))
    acc = ext_f.ZERO_S
    xp = ext_f.ONE_S
    for c in final_monomials:
        acc = ext_f.add_s(acc, ext_f.mul_s(c, xp))
        xp = ext_f.mul_by_base_s(xp, x)
    return tuple(acc) == tuple(cur_expected)
