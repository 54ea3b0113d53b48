"""Stage 2: the copy-permutation grand product z and its partial products.

Plain PyTorch on word tensors (no Pallas kernel carried this stage in the
JAX package either): per chunk of copy columns the products of
num = w + beta·k·x + gamma and den = w + beta·sigma + gamma, one batch
inversion of every chunk denominator, the row ratio, an exclusive prefix
product for z (z(w^0) = 1) and the cumulative partial products.
"""

from __future__ import annotations

import torch

from ..field import extension as ext_f
from ..field import goldilocks as gf
from .quotient_sweep import chunk_columns, chunk_num_den


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
