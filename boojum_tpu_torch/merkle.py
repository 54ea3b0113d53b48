"""Merkle tree with cap over Poseidon2 digests, built on the device.

Leaves are the rows of a committed column stack (all columns at one LDE
point, full domain in bit-reversed order); each layer is one batched kernel
launch (leaf sponge, then 2-to-1 node hashes) up to the cap of 2^k nodes.
Query paths are gathered from the device layers, one gather per layer.
"""

from __future__ import annotations

import numpy as np
import torch

from .field import goldilocks as gf
from .hashes.poseidon2 import Poseidon2SpongeHost, leaf_hash, node_hash


def leaf_digests_device(cols: torch.Tensor) -> torch.Tensor:
    """(B, ...) committed columns -> (N, 4) leaf digests; leaf r holds the
    B words at flat position r of every column."""
    B = cols.shape[0]
    return leaf_hash(cols.reshape(B, -1).contiguous())


def node_layers_device(digests: torch.Tensor, cap_size: int) -> list:
    """(N, 4) leaf digests -> every layer from the leaves up to the cap."""
    layers = [digests]
    while layers[-1].shape[0] > cap_size:
        layers.append(node_hash(layers[-1]))
    return layers


def commit_layers_device(cols: torch.Tensor, cap_size: int) -> list:
    """Column stack -> digest layers, leaves first and cap last."""
    return node_layers_device(leaf_digests_device(cols), cap_size)


def _host_digests(t: torch.Tensor) -> list:
    return [tuple(int(x) for x in row) for row in gf.to_numpy(t)]


class MerkleTreeWithCap:
    def __init__(self, layers: list, cap_size: int):
        n = int(layers[0].shape[0])
        if n & (n - 1) or cap_size & (cap_size - 1) or n < cap_size:
            raise ValueError(f"bad tree geometry: {n} leaves, cap {cap_size}")
        self.cap_size = cap_size
        self.num_leaves = n
        self.layers = list(layers)
        self._cap_host = _host_digests(self.layers[-1])

    @classmethod
    def from_columns(cls, cols: torch.Tensor, cap_size: int):
        return cls(commit_layers_device(cols, cap_size), cap_size)

    @classmethod
    def from_digests(cls, digests: torch.Tensor, cap_size: int):
        """A tree over (N, 4) leaf digests hashed elsewhere (the streamed
        commit), so the leaf columns never exist at once."""
        return cls(node_layers_device(digests, cap_size), cap_size)

    def get_cap(self):
        return list(self._cap_host)

    def get_proofs(self, leaf_indices):
        """Sibling paths for many leaves: one device gather per layer and
        one transfer for the whole tree."""
        idxs = np.asarray(list(leaf_indices), dtype=np.int64)
        dev = self.layers[0].device
        cur = torch.from_numpy(idxs).to(dev)
        sibs = []
        for layer in self.layers[:-1]:
            sibs.append(layer[cur ^ 1])
            cur = cur >> 1
        if not sibs:
            return [[] for _ in idxs]
        levels = gf.to_numpy(torch.stack(sibs))  # (levels, Q, 4)
        return [
            [tuple(int(x) for x in levels[lv, q]) for lv in range(levels.shape[0])]
            for q in range(len(idxs))
        ]


def verify_proof_over_cap(leaf_values, path, cap, leaf_idx: int) -> bool:
    """Host-side path check (python ints)."""
    digest = Poseidon2SpongeHost.hash_leaf([int(v) for v in leaf_values])
    idx = leaf_idx
    for sib in path:
        if idx & 1:
            digest = Poseidon2SpongeHost.hash_node(sib, digest)
        else:
            digest = Poseidon2SpongeHost.hash_node(digest, sib)
        idx >>= 1
    return tuple(digest) == tuple(cap[idx])
