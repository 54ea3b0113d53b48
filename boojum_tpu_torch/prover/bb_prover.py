"""The BabyBear mini-STARK (the JAX package's prover/bb_prover.py).

The statement: a length-n trace of the square map w[i+1] = w[i]^2 + c
with w[0] = pub. One committed trace column, one alpha-combined ext
quotient (4 base columns), DEEP at an ext point z, factor-2 natural-order
FRI down to a raw final codeword, blake2s proof of work and
transcript-drawn queries, every round absorbed into the BabyBear
Poseidon2 transcript with the JAX package's checkpoint labels. The
commits are kernel B8; the rest is plain PyTorch on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..field import babybear as bb
from ..field.spec import BABYBEAR
from ..ntt import bb_ntt
from ..transcript import BitSource, Poseidon2BabyBearTranscript
from . import bb_kernels as BK
from .pow import blake2s_pow_grind
from .prover_bb import eval_at_ext


@dataclasses.dataclass(frozen=True)
class BBProofConfig:
    log_n: int = 10
    lde_factor: int = 4
    shift: int = BABYBEAR.multiplicative_generator
    square_c: int = 7  # the transition constant of the square map
    num_queries: int = 20
    pow_bits: int = 8
    cap_size: int = 8
    final_len: int = 32  # raw FRI final codeword length

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def domain_len(self) -> int:
        return self.n * self.lde_factor

    @property
    def num_folds(self) -> int:
        return (self.domain_len // self.final_len).bit_length() - 1

    def params_list(self) -> list:
        return [self.log_n, self.lde_factor, self.shift, self.square_c,
                self.num_queries, self.pow_bits, self.cap_size, self.final_len]


@dataclasses.dataclass
class BBProof:
    config: BBProofConfig
    pub: int
    witness_cap: list
    quotient_cap: list
    evals: dict  # {"wz": ext, "wgz": ext, "qz": [ext x4]}
    fri_caps: list  # caps of layers 1..num_folds-1
    final_codeword: list  # final_len ext 4-tuples
    pow_nonce: int
    query_indices: list
    queries: list  # per query: {"pos", "w", "q", "fri"} openings


def build_trace(pub: int, cfg: BBProofConfig) -> np.ndarray:
    """w[0] = pub, w[i+1] = w[i]^2 + c over H, natural order."""
    w = [int(pub) % bb.P]
    c = cfg.square_c
    for _ in range(cfg.n - 1):
        w.append((w[-1] * w[-1] + c) % bb.P)
    return np.array(w, dtype=np.uint32)


def _flat_cap(cap) -> list:
    return [int(v) for digest in cap for v in digest]


def _flat_ext_list(vals) -> list:
    return [int(c) for e in vals for c in e]


def _openings(values: torch.Tensor, idx: list, tree) -> list:
    """(leaf values, path) of a (B, M) oracle at each index."""
    vals = bb.to_numpy(values[:, torch.tensor(idx, dtype=torch.int64,
                                              device=values.device)])
    paths = tree.get_paths(idx)
    return [([int(x) for x in vals[:, q]], paths[q]) for q in range(len(idx))]


def prove_babybear(pub: int, cfg: BBProofConfig | None = None, device="cuda",
                   log=None) -> BBProof:
    device = resolve_device(device)
    cfg = cfg or BBProofConfig()
    checkpoint = log.add if log is not None else (lambda *_a: None)
    dev = str(device)
    pub = int(pub) % bb.P
    n, L, N = cfg.n, cfg.lde_factor, cfg.domain_len
    log_N = N.bit_length() - 1

    t = Poseidon2BabyBearTranscript()
    params = cfg.params_list() + [pub]
    t.witness_field_elements(params)
    checkpoint(0, "bb_params", params)

    # round 1: trace -> monomials -> LDE -> witness commitment
    w_mono = bb_ntt.monomial_from_values(bb.from_numpy(build_trace(pub, cfg), device))
    w_lde = bb_ntt.lde(w_mono, L, cfg.shift)
    w_tree = BK.BBMerkleTree.commit(w_lde[None, :], cfg.cap_size, paired=False)
    w_cap = w_tree.get_cap()
    t.witness_merkle_tree_cap(w_cap)
    checkpoint(1, "witness_cap", _flat_cap(w_cap))

    # round 2: the constraint-combining challenge
    alpha = t.get_ext_challenge()
    checkpoint(2, "alpha", list(alpha))

    # round 3: the quotient over the coset -> its commitment -> z
    args = (cfg.log_n, L, cfg.shift, dev)
    q_cols = BK.coset_sweep_terms_bb(w_lde, alpha, cfg.square_c, pub,
                                     BK.last_row_term_bb(*args), BK.zh_inv_bb(*args),
                                     BK.boundary_inv_bb(*args), L)
    q_tree = BK.BBMerkleTree.commit(q_cols, cfg.cap_size, paired=False)
    q_cap = q_tree.get_cap()
    t.witness_merkle_tree_cap(q_cap)
    checkpoint(3, "quotient_cap", _flat_cap(q_cap))
    z = t.get_ext_challenge()
    checkpoint(3, "z", list(z))

    # round 4: evaluations at z and g·z
    gz = bb.ext_scale_s(z, bb.omega(cfg.log_n))
    zpows = bb.ext_powers(z, N, device)
    wz = eval_at_ext(w_mono[None, :], zpows[:, :n])[0]
    wgz = eval_at_ext(w_mono[None, :], bb.ext_powers(gz, n, device))[0]
    q_monos = bb_ntt.coset_descale(bb_ntt.monomial_from_values(q_cols), cfg.shift)
    qz = eval_at_ext(q_monos, zpows)
    del zpows, q_monos
    evals_flat = _flat_ext_list([wz, wgz] + qz)
    t.witness_field_elements(evals_flat)
    checkpoint(4, "evals", evals_flat)
    gammas = [t.get_ext_challenge() for _ in range(6)]
    checkpoint(4, "deep_gammas", _flat_ext_list(gammas))

    # round 5: DEEP codeword -> FRI -> proof of work -> queries
    xs = BK.domain_xs_bb(*args[:3], dev)
    cur = BK.deep_accumulate_bb(w_lde, q_cols, xs, z, gz, wz, wgz, qz, gammas)
    fold_tables = BK.fri_fold_tables_bb(log_N, cfg.shift, cfg.num_folds, dev)
    fri_trees, fri_caps, layers = [], [], [cur]
    for r in range(cfg.num_folds):
        if r > 0:
            tree = BK.BBMerkleTree.commit(cur, min(cfg.cap_size, cur.shape[-1] // 2))
            cap = tree.get_cap()
            t.witness_merkle_tree_cap(cap)
            checkpoint(5, f"fri_cap_{r}", _flat_cap(cap))
            fri_trees.append(tree)
            fri_caps.append(cap)
        beta = t.get_ext_challenge()
        checkpoint(5, f"fri_beta_{r}", list(beta))
        cur = BK.fri_fold_bb(cur, beta, fold_tables[r])
        layers.append(cur)
    final_host = bb.to_numpy(cur)
    final = [tuple(int(final_host[k, j]) for k in range(4)) for j in range(cfg.final_len)]
    final_flat = _flat_ext_list(final)
    t.witness_field_elements(final_flat)
    checkpoint(5, "fri_final", final_flat)
    nonce = blake2s_pow_grind(t, cfg.pow_bits)
    checkpoint(5, "pow_nonce", [nonce])
    bits = BitSource(log_N, challenge_bits=BABYBEAR.challenge_bits)
    idxs = [bits.get_index(t, log_N) for _ in range(cfg.num_queries)]
    checkpoint(5, "query_indices", idxs)

    # query openings: both fold points of the trace and the quotient, then
    # one paired leaf of each committed FRI layer
    j0 = [pos % (N // 2) for pos in idxs]
    w_open = [_openings(w_lde[None, :], [j + s for j in j0], w_tree) for s in (0, N // 2)]
    q_open = [_openings(q_cols, [j + s for j in j0], q_tree) for s in (0, N // 2)]
    fri_open, p = [], j0
    for r in range(1, cfg.num_folds):
        M = N >> r
        leaf = [x % (M // 2) for x in p]
        lay = layers[r]
        fri_open.append(_openings(torch.cat([lay[:, : M // 2], lay[:, M // 2 :]]), leaf,
                                  fri_trees[r - 1]))
        p = leaf
    queries = [
        {"pos": int(pos), "w": [w_open[0][q], w_open[1][q]],
         "q": [q_open[0][q], q_open[1][q]], "fri": [f[q] for f in fri_open]}
        for q, pos in enumerate(idxs)
    ]
    return BBProof(
        config=cfg,
        pub=pub,
        witness_cap=w_cap,
        quotient_cap=q_cap,
        evals={"wz": wz, "wgz": wgz, "qz": qz},
        fri_caps=fri_caps,
        final_codeword=final,
        pow_nonce=int(nonce),
        query_indices=[int(i) for i in idxs],
        queries=queries,
    )
