"""BabyBear NTT and coset LDE, natural order in and out (plain PyTorch).

The counterpart of the JAX package's ntt/bb_ntt.py, which is XLA and not
a Pallas kernel: a bit-reverse permutation, then log_n radix-2 DIT stages
over the last axis.
- `ntt(values, inverse=True)`: natural-order evaluations over the size-n
  subgroup -> monomial coefficients (including 1/n);
- `ntt(mono)`: the forward transform;
- `lde(mono, L, shift)`: monomials -> natural-order evaluations over the
  coset shift·<w_N>, N = n·L. Subcoset r is shift·w_N^r·<w_n>: its
  size-n NTT lands at positions j = r + q·L, so the (L, n) stack
  transposes into the natural-order table.
Tensors hold int32 words; the stages run in int64 and rows go through in
blocks that bound the int64 temporaries.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..field import babybear as bb
from .ntt import bitreverse_indices

BLOCK_ELEMS = 1 << 26  # int64 words of one block's widest temporary


def _log2(n: int) -> int:
    log_n = n.bit_length() - 1
    if n < 1 or 1 << log_n != n:
        raise ValueError(f"transform size {n} is not a power of two")
    return log_n


@lru_cache(maxsize=32)
def _twiddles(log_n: int, inverse: bool, device: str):
    """Stage s (half = 2^s) multiplies by w_{2^(s+1)}^k, k < half."""
    n = 1 << log_n
    w = bb.omega(log_n)
    if inverse:
        w = bb.inv_s(w)
    full = bb.powers(w, max(n // 2, 1), device, torch.int64)
    return [full[:: n // (2 << s)][: 1 << s].contiguous() for s in range(log_n)]


def _ntt_core(x: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    """int64 (..., n) natural -> natural, without the 1/n."""
    n = 1 << log_n
    if n == 1:
        return x
    y = x[..., bitreverse_indices(log_n, x.device)]
    lead = y.shape[:-1]
    for s, tw in enumerate(_twiddles(log_n, inverse, str(x.device))):
        half = 1 << s
        y = y.reshape(*lead, n // (2 * half), 2 * half)
        even = y[..., :half]
        odd = (y[..., half:] * tw) % bb.P
        s_ = even + odd
        d_ = even - odd
        y = torch.cat([torch.where(s_ >= bb.P, s_ - bb.P, s_),
                       torch.where(d_ < 0, d_ + bb.P, d_)], dim=-1)
    return y.reshape(*lead, n)


def _blocks(rows: int, per_row: int):
    step = max(1, BLOCK_ELEMS // max(per_row, 1))
    return [slice(i, min(i + step, rows)) for i in range(0, rows, step)]


def ntt(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """(..., n) natural -> (..., n) natural; inverse divides by n."""
    n = x.shape[-1]
    log_n = _log2(n)
    flat = x.reshape(-1, n)
    out = torch.empty(flat.shape, dtype=x.dtype, device=x.device)
    n_inv = bb.inv_s(n)
    for blk in _blocks(flat.shape[0], n):
        y = _ntt_core(flat[blk].to(torch.int64), log_n, inverse)
        if inverse:
            y = (y * n_inv) % bb.P
        out[blk] = y.to(x.dtype)
    return out.reshape(x.shape)


def monomial_from_values(values: torch.Tensor) -> torch.Tensor:
    return ntt(values, inverse=True)


@lru_cache(maxsize=16)
def _lde_scale(log_n: int, lde_factor: int, shift: int, device: str) -> torch.Tensor:
    """(L, n) int64: row r holds (shift·w_N^r)^i."""
    n = 1 << log_n
    w_big = bb.omega(log_n + _log2(lde_factor))
    return torch.stack([
        bb.powers(bb.mul_s(shift % bb.P, bb.pow_s(w_big, r)), n, device, torch.int64)
        for r in range(lde_factor)
    ])


def lde(mono: torch.Tensor, lde_factor: int, shift: int = bb.MULTIPLICATIVE_GENERATOR
        ) -> torch.Tensor:
    """(..., n) monomials -> (..., n·L) natural-order evaluations over
    shift·<w_{n·L}>."""
    n = mono.shape[-1]
    log_n = _log2(n)
    L = lde_factor
    scale = _lde_scale(log_n, L, shift, str(mono.device))
    flat = mono.reshape(-1, n)
    out = torch.empty((flat.shape[0], n * L), dtype=mono.dtype, device=mono.device)
    for blk in _blocks(flat.shape[0], n * L):
        scaled = (flat[blk].to(torch.int64)[:, None, :] * scale) % bb.P
        evals = _ntt_core(scaled, log_n, False)  # (b, L, n)
        out[blk] = evals.transpose(1, 2).reshape(-1, n * L).to(mono.dtype)
    return out.reshape(*mono.shape[:-1], n * L)


def coset_descale(mono_like: torch.Tensor, shift: int) -> torch.Tensor:
    """Values over shift·<w_N> run through the plain inverse NTT give
    u_i = m_i·shift^i; multiply by shift^-i to recover m."""
    N = mono_like.shape[-1]
    tbl = bb.powers(bb.inv_s(shift % bb.P), N, mono_like.device)
    return bb.mul(mono_like, tbl)
