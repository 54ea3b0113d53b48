"""BabyBear domain tables, FRI fold, Merkle commits and path checks.

The JAX package's prover/bb_kernels.py, on int32 word tensors. Every table
is in NATURAL order over the coset shift·<w_N>, N = n·L (ntt/bb_ntt.py);
extension values are (4, ...) tensors. The domain tables depend only on
the domain's shape; they are built on the device and cached per device.

Merkle trees commit PAIRED leaves: leaf j of a (B, N) oracle holds its
columns at j and at j + N/2, so one path opens both points a factor-2 FRI
fold pairs. Leaf sponges and node layers are kernel B8
(hashes/poseidon2_bb.py); the tree keeps its layers on the device and
gathers the paths of all queries at once.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..field import babybear as bb
from ..hashes import poseidon2_bb as p2bb

SHIFT = bb.MULTIPLICATIVE_GENERATOR  # the LDE coset shift, 31
INV2 = bb.INV2


# ---------------------------------------------------------------------------
# Domain tables (witness-independent, cached per domain shape and device)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=16)
def domain_xs_bb(log_n: int, lde_factor: int, shift: int, device: str) -> torch.Tensor:
    """x_j = shift·w_N^j, j < N."""
    N = (1 << log_n) * lde_factor
    w = bb.omega(N.bit_length() - 1)
    return bb.mul(bb.powers(w, N, device), shift % bb.P)


@lru_cache(maxsize=8)
def zh_inv_bb(log_n: int, lde_factor: int, shift: int, device: str) -> torch.Tensor:
    """1/(x_j^n - 1) over the coset: x_j^n = shift^n·w_L^(j mod L) takes
    only L values, inverted on the host and tiled."""
    n = 1 << log_n
    L = lde_factor
    sh_n = bb.pow_s(shift % bb.P, n)
    wl = bb.omega(L.bit_length() - 1)
    base = [bb.inv_s(bb.sub_s(bb.mul_s(sh_n, bb.pow_s(wl, r)), 1)) for r in range(L)]
    return torch.tensor(base, dtype=bb.DTYPE, device=device).repeat(n)


@lru_cache(maxsize=4)
def last_row_term_bb(log_n: int, lde_factor: int, shift: int, device: str) -> torch.Tensor:
    """x_j - g^(n-1), g = w_n: the transition constraint's excluded row."""
    g_last = bb.pow_s(bb.omega(log_n), (1 << log_n) - 1)
    return bb.sub(domain_xs_bb(log_n, lde_factor, shift, device), g_last)


@lru_cache(maxsize=4)
def boundary_inv_bb(log_n: int, lde_factor: int, shift: int, device: str) -> torch.Tensor:
    """1/(x_j - 1) (1 is on no proper coset)."""
    return bb.inv(bb.sub(domain_xs_bb(log_n, lde_factor, shift, device), 1))


@lru_cache(maxsize=4)
def fri_fold_tables_bb(log_N: int, shift: int, num_rounds: int, device: str):
    """Round r folds the length-N_r codeword over shift^(2^r)·<w_{N_r}>,
    pairing j with j + N_r/2: table[r][j] = 1/(2·x_j) for j < N_r/2."""
    tables = []
    for r in range(num_rounds):
        log_r = log_N - r
        sh = bb.pow_s(shift % bb.P, 1 << r)
        xs = bb.mul(bb.powers(bb.omega(log_r), 1 << (log_r - 1), device), sh)
        tables.append(bb.inv(bb.mul(xs, 2)))
    return tuple(tables)


# ---------------------------------------------------------------------------
# Codeword math
# ---------------------------------------------------------------------------


def base_minus_ext(base: torch.Tensor, e) -> torch.Tensor:
    """(base - e) as a (4, ...) ext tensor, e a host ext scalar."""
    out = torch.empty((4, *base.shape), dtype=base.dtype, device=base.device)
    out[0] = bb.sub(base, e[0])
    for k in range(1, 4):
        out[k] = bb.neg_s(int(e[k]))
    return out


def coset_sweep_terms_bb(w_lde, alpha, c: int, pub: int, last_tbl, zh_inv_tbl,
                         bnd_inv_tbl, lde_factor: int) -> torch.Tensor:
    """The mini-STARK's quotient over the coset, (4, N): the transition
    quotient (w(gx) - w(x)^2 - c)(x - g_last)/Z_H(x) plus alpha times the
    boundary quotient (w(x) - pub)/(x - 1). w(g·x_j) = w(x_{j+L})."""
    wg = torch.roll(w_lde, -lde_factor)
    trans = bb.sub(wg, bb.add(bb.sqr(w_lde), c))
    qt = bb.mul(bb.mul(trans, last_tbl), zh_inv_tbl)
    qb = bb.mul(bb.sub(w_lde, pub), bnd_inv_tbl)
    return bb.ext_add(bb.ext_from_base(qt), bb.ext_scale(alpha, qb))


def deep_accumulate_bb(w_lde, q_cols, xs, z, gz, wz, wgz, qz, gammas) -> torch.Tensor:
    """The mini-STARK's DEEP codeword (4, N):
    [g0 (w - w(z)) + sum_k g_{2+k} (Q_k - Q_k(z))] / (x - z)
    + g1 (w - w(gz)) / (x - gz)."""
    num = bb.ext_mul(base_minus_ext(w_lde, wz), gammas[0])
    for k in range(4):
        num = bb.ext_add(num, bb.ext_mul(base_minus_ext(q_cols[k], qz[k]), gammas[2 + k]))
    d1 = bb.ext_mul(num, bb.ext_inv(base_minus_ext(xs, z)))
    shifted = bb.ext_mul(base_minus_ext(w_lde, wgz), gammas[1])
    d2 = bb.ext_mul(shifted, bb.ext_inv(base_minus_ext(xs, gz)))
    return bb.ext_add(d1, d2)


def fri_fold_bb(codeword: torch.Tensor, beta, inv2x: torch.Tensor) -> torch.Tensor:
    """One factor-2 natural-order fold of a (4, M) ext codeword, pairing j
    with j + M/2: f'(x^2) = (f(x) + f(-x))/2 + beta (f(x) - f(-x))/(2x)."""
    half = codeword.shape[-1] // 2
    a, b = codeword[:, :half], codeword[:, half:]
    even = bb.mul(bb.add(a, b), INV2)
    odd = bb.mul(bb.sub(a, b), inv2x)
    return bb.ext_add(even, bb.ext_mul(odd, beta))


# ---------------------------------------------------------------------------
# Merkle commits (8-word digests, kernel B8)
# ---------------------------------------------------------------------------


def node_layers_bb(digests: torch.Tensor, cap_size: int) -> list:
    """(M, 8) leaf digests -> every layer up to the cap."""
    layers = [digests]
    while layers[-1].shape[0] > cap_size:
        layers.append(p2bb.node_layer_bb(layers[-1]))
    return layers


class BBMerkleTree:
    """Cap-terminated Merkle tree whose layers stay on the device."""

    def __init__(self, layers):
        self.layers = list(layers)
        self._cap = None

    @classmethod
    def commit(cls, cols: torch.Tensor, cap_size: int, paired: bool = True):
        """The tree of a (B, N) oracle, over paired leaves by default."""
        return cls(node_layers_bb(p2bb.leaf_hash_bb(cols, paired), cap_size))

    def get_cap(self) -> list:
        if self._cap is None:
            self._cap = [tuple(int(x) for x in row) for row in bb.to_numpy(self.layers[-1])]
        return self._cap

    def get_paths(self, leaf_idxs) -> list:
        """The sibling digests from each leaf up to the cap, for all leaves
        at once (one gather per layer, one copy to the host)."""
        dev = self.layers[0].device
        idx = torch.as_tensor(list(leaf_idxs), dtype=torch.int64, device=dev)
        sibs = []
        for layer in self.layers[:-1]:
            sibs.append(layer[idx ^ 1])
            idx = idx >> 1
        if not sibs:
            return [[] for _ in leaf_idxs]
        host = bb.to_numpy(torch.stack(sibs, dim=1))  # (q, depth, 8)
        return [[tuple(int(x) for x in d) for d in q] for q in host]


def verify_path_bb(leaf_values, path, cap, leaf_idx: int) -> bool:
    """Check one opened leaf against a cap (host python ints)."""
    digest = p2bb.leaf_hash_bb_host(leaf_values)
    idx = int(leaf_idx)
    for sib in path:
        if idx & 1:
            digest = p2bb.node_hash_bb_host(sib, digest)
        else:
            digest = p2bb.node_hash_bb_host(digest, sib)
        idx >>= 1
    return idx < len(cap) and tuple(digest) == tuple(cap[idx])
