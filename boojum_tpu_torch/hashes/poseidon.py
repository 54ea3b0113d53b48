"""The legacy Poseidon permutation over Goldilocks (width 12, x^7), on word
tensors and on host ints, as in the JAX package's hashes/poseidon.py
(era-boojum poseidon_goldilocks.rs and suggested_mds.rs): the original
round function beside Poseidon2, with Plonky2's MDS matrix and round
constants. Rate 8, capacity 4; 4 full, 22 partial and 4 full rounds, each
add-constants, S-box (every lane in a full round, lane 0 in a partial one),
then the MDS: the circulant of powers of two with exponents
[0, 0, 1, 0, 3, 5, 1, 8, 12, 3, 16, 10], M[r][c] = 2^exps[(c - r) mod 12].

It drives the `poseidon` transcript only: Merkle trees hash with Poseidon2
whatever the transcript. The JAX package runs it as XLA outside any Pallas
kernel, so the tensor form here is plain PyTorch.
"""

from __future__ import annotations

import torch

from ..field import gl
from ..field import goldilocks as gf
from . import poseidon2_params as params
from .poseidon2 import Poseidon2SpongeHost

RC = [[int(v) for v in params.ALL_ROUND_CONSTANTS[12 * r:12 * (r + 1)]] for r in range(30)]
MDS_MATRIX_EXPS = [0, 0, 1, 0, 3, 5, 1, 8, 12, 3, 16, 10]


def _sbox7(x):
    x2 = gf.sqr(x)
    return gf.mul(gf.sqr(x2), gf.mul(x2, x))


def _mds(s):
    out = []
    for r in range(12):
        acc = None
        for c in range(12):
            term = gf.mul_small(s[c], 1 << MDS_MATRIX_EXPS[(c - r) % 12])
            acc = term if acc is None else gf.add(acc, term)
        out.append(acc)
    return out


def poseidon_permutation(state: torch.Tensor) -> torch.Tensor:
    """The permutation of each row of a (..., 12) word tensor."""
    s = [state[..., i] for i in range(12)]
    for r in range(30):
        s = [gf.add(v, RC[r][i]) for i, v in enumerate(s)]
        if 4 <= r < 26:
            s[0] = _sbox7(s[0])
        else:
            s = [_sbox7(v) for v in s]
        s = _mds(s)
    return torch.stack(s, dim=-1)


def leaf_hash(values: torch.Tensor) -> torch.Tensor:
    """(..., L) words -> (..., 4) digests: each full chunk of 8 overwrites
    the rate and permutes, a last partial chunk is zero-padded."""
    lead, L = values.shape[:-1], values.shape[-1]
    state = torch.zeros(*lead, 12, dtype=torch.int64, device=values.device)
    for c0 in range(0, L, 8):
        chunk = values[..., c0:c0 + 8]
        pad = torch.zeros(*lead, 8 - chunk.shape[-1], dtype=torch.int64, device=values.device)
        state = poseidon_permutation(torch.cat([chunk, pad, state[..., 8:]], dim=-1))
    return state[..., :4]


def _sbox7_s(x):
    x2 = gl.sqr(x)
    return gl.mul(gl.sqr(x2), gl.mul(x2, x))


def _mds_s(s):
    out = []
    for r in range(12):
        acc = 0
        for c in range(12):
            acc = gl.add(acc, gl.mul(s[c], 1 << MDS_MATRIX_EXPS[(c - r) % 12]))
        out.append(acc)
    return out


def poseidon_permutation_host(state: list) -> list:
    s = [int(v) for v in state]
    for r in range(30):
        s = [gl.add(v, RC[r][i]) for i, v in enumerate(s)]
        if 4 <= r < 26:
            s[0] = _sbox7_s(s[0])
        else:
            s = [_sbox7_s(v) for v in s]
        s = _mds_s(s)
    return s


class PoseidonSpongeHost(Poseidon2SpongeHost):
    """The overwrite-mode sponge (rate 8, capacity 4) over the legacy
    permutation."""

    _PERMUTATION = staticmethod(poseidon_permutation_host)
