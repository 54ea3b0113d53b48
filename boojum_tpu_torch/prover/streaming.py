"""Streamed commits: oracles committed and reopened from their monomials,
never holding their rate-L LDE (the JAX package's prover/streaming.py,
meshless, on 64-bit words).

- Commit: the monomials go through the coset LDE COL_BLOCK columns at a
  time, and each block's columns are absorbed, 8 a permutation, into sponge
  states carried across blocks (kernel B4's absorb). The digests equal
  `leaf_hash` over whole rows, so trees and proofs are byte-identical to the
  materialized path's.
- DEEP and query openings: `MonomialSource` regenerates the blocks (one more
  LDE pass each), trading transforms for the storage of the LDE.

The prover streams when its oracles' committed storage would pass
`threshold_bytes` (1.5 GiB by default, the JAX package's default; 0 always
streams and math.inf never does, its BOOJUM_TPU_STREAM_LDE values "1" and
"0"); the setup applies the same rule to its own columns.
"""

from __future__ import annotations

import torch

from ..hashes.poseidon2 import absorb_cols
from ..merkle import MerkleTreeWithCap
from ..ntt import lde_from_monomial

COL_BLOCK = 32  # columns per streamed block, a multiple of the sponge rate 8
STREAM_THRESHOLD_BYTES = 1536 << 20


def use_streamed_lde(total_cols: int, domain_size: int,
                     threshold_bytes: float = STREAM_THRESHOLD_BYTES) -> bool:
    """Stream when total_cols columns of domain_size words pass the
    threshold."""
    return total_cols * domain_size * 8 > threshold_bytes


class MonomialSource:
    """A committed oracle as its (B, n) monomials and its rate L: stands in
    for the (B, L·n) LDE in round 5 and regenerates columns on demand."""

    def __init__(self, mono: torch.Tensor, L: int):
        self.mono = mono
        self.L = int(L)

    @property
    def shape(self):
        return (self.mono.shape[0], self.mono.shape[1] * self.L)

    def blocks(self, per: int = COL_BLOCK):
        """(first column, (b, L·n) LDE block) for each block of `per`."""
        for i in range(0, self.mono.shape[0], per):
            lde = lde_from_monomial(self.mono[i : i + per], self.L)
            yield i, lde.reshape(lde.shape[0], -1)

    def columns(self, idxs) -> torch.Tensor:
        """The LDE of a few columns, (len(idxs), L·n), in one transform."""
        sel = torch.as_tensor(list(idxs), dtype=torch.int64, device=self.mono.device)
        lde = lde_from_monomial(self.mono[sel], self.L)
        return lde.reshape(len(sel), -1)

    def gather_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """(B, len(idx)) leaf values at the LDE points idx, block by block."""
        return torch.cat([flat[:, idx] for _, flat in self.blocks()])


def streamed_leaf_digests_blocks(mono: torch.Tensor, L: int) -> torch.Tensor:
    """(L·n, 4) leaf digests of the rate-L LDE of the (B, n) monomials,
    one column block at a time. Block b+1's LDE is enqueued before block
    b's absorb, as the JAX package's double_buffered_absorb does; the absorb
    order, and so every digest, is that of the sequential loop."""
    B, n = mono.shape
    state = torch.zeros((n * L, 12), dtype=torch.int64, device=mono.device)

    def lde_block(i):
        lde = lde_from_monomial(mono[i : i + COL_BLOCK], L)
        return lde.reshape(lde.shape[0], -1)

    starts = range(0, B, COL_BLOCK)
    nxt = lde_block(starts[0])
    for k in range(len(starts)):
        cols = nxt
        nxt = lde_block(starts[k + 1]) if k + 1 < len(starts) else None
        absorb_cols(state, cols)
    return state[:, :4].contiguous()


def commit_streaming(mono: torch.Tensor, L: int, cap_size: int) -> MerkleTreeWithCap:
    """Merkle-commit the rate-L LDE of `mono` without holding it."""
    return MerkleTreeWithCap.from_digests(streamed_leaf_digests_blocks(mono, L), cap_size)


def deep_source_blocks(sources, per_bytes: int):
    """(block (b, N), first column) across the oracles in order: a tensor
    is sliced by a byte budget, a MonomialSource regenerates its blocks."""
    off = 0
    for src in sources:
        if isinstance(src, MonomialSource):
            for i, flat in src.blocks():
                yield flat, off + i
        else:
            B, N = src.shape
            per = max(1, per_bytes // (N * 8))
            for i in range(0, B, per):
                yield src[i : i + per], off + i
        off += src.shape[0]
