"""Stage 2: the copy-permutation grand product z and its partial products,
and the lookup polynomials A_i and B (specialized and general mode).

Plain PyTorch on word tensors (no Pallas kernel carried this stage in the
JAX package either): per chunk of copy columns the products of
num = w + beta·k·x + gamma and den = w + beta·sigma + gamma, one batch
inversion of every chunk denominator, the row ratio, an exclusive prefix
product for z (z(w^0) = 1) and the cumulative partial products. The
log-derivative lookup polynomials come from the R + 1 aggregated
denominators, inverted in one stacked batch inversion.
"""

from __future__ import annotations

import torch

from ..field import extension as ext_f
from ..field import goldilocks as gf
from .layout import chunk_columns
from .quotient_sweep import aggregate_lookup_columns, chunk_num_den


def z_and_partials(num_all, den_inv_all):
    """Chunk ratios -> z (exclusive prefix product of the row ratio) and
    the K - 1 partial products, as one (2 + 2(K - 1), n) column stack
    [z0, z1, p0_0, p0_1, ...]."""
    K = num_all[0].shape[0]
    ratios = ext_f.mul(num_all, den_inv_all)
    full = (ratios[0][0], ratios[1][0])
    for j in range(1, K):
        full = ext_f.mul(full, (ratios[0][j], ratios[1][j]))
    incl = ext_f.prefix_product(full)
    z0 = torch.ones_like(incl[0])
    z1 = torch.zeros_like(incl[1])
    z0[1:] = incl[0][:-1]
    z1[1:] = incl[1][:-1]
    cols = [z0, z1]
    acc = (z0, z1)
    for j in range(K - 1):
        acc = ext_f.mul(acc, (ratios[0][j], ratios[1][j]))
        cols += [acc[0], acc[1]]
    return torch.stack(cols)


def stage2_columns(copy_vals, sigma_vals, non_residues, xs, beta, gamma,
                   max_degree):
    """The stage-2 oracle's columns over H (natural row order)."""
    chunks = chunk_columns(copy_vals.shape[0], max_degree)
    num_all, den_all = chunk_num_den(
        copy_vals, sigma_vals, non_residues, xs, beta, gamma, chunks
    )
    return z_and_partials(num_all, ext_f.batch_inverse(den_all))


def _lookup_denominators(lookup_cols, table_id_col, table_cols, beta, gamma,
                         num_repetitions, width):
    """(R + 1, n) stacked ext pair: the R sub-argument denominators, then
    the table's."""
    gpow = ext_f.powers_s(gamma, width + 1)
    dens = [
        aggregate_lookup_columns(
            [lookup_cols[i * width + j] for j in range(width)], table_id_col, gpow, beta
        )
        for i in range(num_repetitions)
    ]
    dens.append(aggregate_lookup_columns(
        [table_cols[j] for j in range(width)], table_cols[width], gpow, beta
    ))
    return torch.stack([d[0] for d in dens]), torch.stack([d[1] for d in dens])


def compute_lookup_polys(lookup_cols, table_id_col, table_cols, multiplicities,
                         lookup_beta, lookup_gamma, num_repetitions, width):
    """A_i and B over H, each an ext pair:
      A_i(x) = 1 / (Σ_j γ^j·w_{i,j}(x) + γ^w·table_id(x) + β)
      B(x)   = M(x) / (Σ_j γ^j·t_j(x) + γ^w·t_id(x) + β)
    lookup_cols (R·w, n); table_id_col, multiplicities (n,); table_cols
    (w + 1, n), the id column last."""
    R = int(num_repetitions)
    inv = ext_f.batch_inverse(_lookup_denominators(
        lookup_cols, table_id_col, table_cols, lookup_beta, lookup_gamma, R, int(width)
    ))
    a_polys = [(inv[0][i], inv[1][i]) for i in range(R)]
    b_poly = (gf.mul(inv[0][R], multiplicities), gf.mul(inv[1][R], multiplicities))
    return a_polys, b_poly


def compute_lookup_polys_general(gen_cols, table_id_col, table_cols, multiplicities, sel,
                                 lookup_beta, lookup_gamma, num_subargs, width):
    """A_i and B over H in general mode (the JAX package's stages.py
    compute_lookup_polys_general): the sub-arguments tile the general copy
    columns gen_cols (R·w, n), the table id is the marker's constant column,
    and A_i = sel / den_i, zero off the marker rows (sel the marker selector
    over H, None for the constant 1). B as in compute_lookup_polys."""
    a_polys, b_poly = compute_lookup_polys(gen_cols, table_id_col, table_cols,
                                           multiplicities, lookup_beta, lookup_gamma,
                                           num_subargs, width)
    if sel is not None:
        a_polys = [ext_f.mul_by_base(a, sel) for a in a_polys]
    return a_polys, b_poly
