"""Poseidon2 permutation (Goldilocks, width 12, x^7): batched tensors and host.

Parameter-compatible with era-boojum's Poseidon2 and the JAX package: an
initial external layer circ(2*M4, M4, M4), 4 full rounds, 22 partial rounds
with the internal matrix all-ones + diag(d), 4 full rounds. The sponge is
overwrite-mode, rate 8, capacity 4, the last chunk zero-padded; its leaf and
node forms carry the Merkle trees, and the host mirror carries the transcript
and path verification.

`leaf_hash` and `node_hash` are the wrappers of kernel B5 (csrc/poseidon2.cu,
replacing boojum_tpu/hashes/pallas_poseidon2.py _sponge_kernel);
`poseidon2_permutation` and `absorb_cols` those of kernel B4 (the same
source, replacing _perm_kernel): the bare permutation of (N, 12) states, and
the streamed commit's absorb of a column block into carried sponge states.
A CUDA tensor launches the kernel, a CPU tensor runs the plain PyTorch
version below, which is the kernel's reference and used nowhere on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels as K
from ..field import gl
from ..field import goldilocks as gf
from . import poseidon2_params as params

RC = [[int(v) for v in row] for row in params.ROUND_CONSTANTS_PER_ROUND]
DIAG = [int(v) for v in params.M_I_DIAGONAL]


# ---------------------------------------------------------------------------
# Plain PyTorch permutation over a list of 12 word tensors
# ---------------------------------------------------------------------------


def _sbox7_rows(x):
    x2 = gf.sqr(x)
    return gf.mul(gf.sqr(x2), gf.mul(x2, x))


def _external_mds_rows(s):
    """_external_mds over a (12, N) stack: the three M4 blocks at once."""
    x0, x1, x2, x3 = s.view(3, 4, -1).unbind(1)  # each (3, N): lane i of each block
    t0 = gf.add(x0, x1)
    t1 = gf.add(x2, x3)
    t2 = gf.add(gf.double(x1), t1)
    t3 = gf.add(gf.double(x3), t0)
    t4 = gf.add(gf.double(gf.double(t1)), t3)
    t5 = gf.add(gf.double(gf.double(t0)), t2)
    blocks = torch.stack([gf.add(t3, t5), t5, gf.add(t2, t4), t4], dim=1)  # (3, 4, N)
    sums = gf.add(gf.add(blocks[0], blocks[1]), blocks[2])
    return gf.add(blocks, sums).reshape(12, -1)


def _lane_sum(s):
    """Σ of the 12 rows of a (12, N) stack, by halving."""
    s = gf.add(s[:6], s[6:])
    s = gf.add(s[:3], s[3:])
    return gf.add(gf.add(s[0], s[1]), s[2])


def _external_mds(s):
    """The external layer over a list of 12 word tensors."""
    return list(_external_mds_rows(torch.stack(s)).unbind(0))


def _internal_mds(s):
    """The internal layer over a list of 12 word tensors."""
    rows = torch.stack(s)
    diag = _row_tables(rows.device)[1].reshape((12,) + (1,) * (rows.dim() - 1))
    return list(gf.add(gf.mul(rows, diag), _lane_sum(rows)).unbind(0))


_TABLES: dict = {}


def _row_tables(device):
    """The round constants (30, 12, 1) and the diagonal of M_I (12, 1) on a
    device, made once."""
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = (gf.from_numpy(np.array(RC, dtype=np.uint64), device)[..., None],
                        gf.from_numpy(np.array(DIAG, dtype=np.uint64), device)[:, None])
    return _TABLES[key]


def permute_plain(state: list) -> list:
    """Poseidon2 over 12 same-shape word tensors (one lane per element):
    each round over the (12, N) stack of the lanes at once."""
    shape = state[0].shape
    s = torch.stack([v.reshape(-1) for v in state])
    rc, diag = _row_tables(s.device)
    s = _external_mds_rows(s)
    for r in range(4):
        s = _external_mds_rows(_sbox7_rows(gf.add(s, rc[r])))
    for r in range(4, 26):
        s = torch.cat([_sbox7_rows(gf.add(s[:1], RC[r][0])), s[1:]])
        s = gf.add(gf.mul(s, diag), _lane_sum(s))
    for r in range(26, 30):
        s = _external_mds_rows(_sbox7_rows(gf.add(s, rc[r])))
    return [v.reshape(shape) for v in s.unbind(0)]


def permutation_plain(state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 of each row of an (N, 12) state stack."""
    return torch.stack(permute_plain([state[:, i] for i in range(12)]), dim=1)


def absorb_cols_plain(state: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Absorb a (b, N) column block into the carried (N, 12) states, in
    place: each chunk of 8 columns overwrites the rate (zero past column b)
    and is permuted (the JAX package's streaming.py _absorb_cols)."""
    b, N = cols.shape
    zero = torch.zeros(N, dtype=torch.int64, device=cols.device)
    s = [state[:, i] for i in range(12)]
    for c0 in range(0, b, 8):
        s[:8] = [cols[c0 + j] if c0 + j < b else zero for j in range(8)]
        s = permute_plain(s)
    state.copy_(torch.stack(s, dim=1))
    return state


def leaf_hash_plain(cols: torch.Tensor) -> torch.Tensor:
    """(B, N) column-major leaf stack -> (N, 4) digests."""
    B, N = cols.shape
    zero = torch.zeros(N, dtype=torch.int64, device=cols.device)
    s = [zero] * 12
    for c0 in range(0, B, 8):
        s[:8] = [cols[c0 + j] if c0 + j < B else zero for j in range(8)]
        s = permute_plain(s)
    return torch.stack(s[:4], dim=1)


def node_hash_plain(children: torch.Tensor) -> torch.Tensor:
    """(2M, 4) digests -> (M, 4) parents hashing children 2i ‖ 2i+1."""
    pairs = children.reshape(-1, 8)
    zero = torch.zeros_like(pairs[:, 0])
    s = permute_plain([pairs[:, k] for k in range(8)] + [zero] * 4)
    return torch.stack(s[:4], dim=1)


# ---------------------------------------------------------------------------
# Kernel wrappers (B5, B4)
# ---------------------------------------------------------------------------

_constants_set: set = set()


def _library(dev: torch.device):
    lib = K.library("poseidon2")
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _constants_set:
        rc = np.array(params.ALL_ROUND_CONSTANTS, dtype=np.uint64)
        with torch.cuda.device(idx):
            K.check(
                lib.bt_poseidon2_set_constants(rc.ctypes.data_as(K._P)),
                "poseidon2 constants",
            )
        _constants_set.add(idx)
    return lib


def leaf_hash(cols: torch.Tensor) -> torch.Tensor:
    """Merkle leaf digests of a (B, N) column-major stack: leaf r absorbs
    cols[:, r]. Returns (N, 4)."""
    K.require(cols, "leaf_hash cols")
    if cols.dim() != 2:
        raise ValueError("leaf_hash expects a (B, N) column stack")
    dev = K.same_device(cols)
    if dev.type == "cpu":
        return leaf_hash_plain(cols)
    B, N = cols.shape
    out = torch.empty((N, 4), dtype=torch.int64, device=dev)
    lib = _library(dev)
    with torch.cuda.device(dev):
        K.count("poseidon2_leaf")
        K.check(
            lib.bt_poseidon2_leaf_hash(
                K.ptr(cols), B, N, K.ptr(out), K.stream(dev)
            ),
            "poseidon2 leaf hash",
        )
    return out


def node_hash(children: torch.Tensor) -> torch.Tensor:
    """One Merkle layer up: (2M, 4) digests -> (M, 4)."""
    K.require(children, "node_hash children")
    if children.dim() != 2 or children.shape[1] != 4 or children.shape[0] % 2:
        raise ValueError("node_hash expects an even (2M, 4) digest layer")
    dev = K.same_device(children)
    if dev.type == "cpu":
        return node_hash_plain(children)
    M = children.shape[0] // 2
    out = torch.empty((M, 4), dtype=torch.int64, device=dev)
    lib = _library(dev)
    with torch.cuda.device(dev):
        K.count("poseidon2_node")
        K.check(
            lib.bt_poseidon2_node_hash(K.ptr(children), M, K.ptr(out), K.stream(dev)),
            "poseidon2 node hash",
        )
    return out


def _require_states(state: torch.Tensor, what: str) -> None:
    K.require(state, what)
    if state.dim() != 2 or state.shape[1] != 12:
        raise ValueError(f"{what}: expected (N, 12) states, got {tuple(state.shape)}")


def poseidon2_permutation(state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 of each row of an (N, 12) state stack; returns a new
    (N, 12) tensor (the JAX package's hashes/poseidon2.py
    poseidon2_permutation)."""
    _require_states(state, "poseidon2_permutation state")
    dev = K.same_device(state)
    if dev.type == "cpu":
        return permutation_plain(state)
    out = torch.empty_like(state)
    lib = _library(dev)
    with torch.cuda.device(dev):
        K.count("poseidon2_permute")
        K.check(
            lib.bt_poseidon2_permute(K.ptr(state), state.shape[0], K.ptr(out),
                                     K.stream(dev)),
            "poseidon2 permutation",
        )
    return out


def absorb_cols(state: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Absorb a (b, N) column-major block, b >= 1, into the carried (N, 12)
    sponge states in place, 8 columns a permutation, the last chunk
    zero-padded; returns `state`. One launch takes the whole block."""
    _require_states(state, "absorb_cols state")
    K.require(cols, "absorb_cols cols")
    if cols.dim() != 2 or cols.shape[0] < 1 or cols.shape[1] != state.shape[0]:
        raise ValueError(f"absorb_cols: a (b, {state.shape[0]}) block, got "
                         f"{tuple(cols.shape)}")
    dev = K.same_device(state, cols)
    if dev.type == "cpu":
        return absorb_cols_plain(state, cols)
    b, N = cols.shape
    lib = _library(dev)
    with torch.cuda.device(dev):
        K.count("poseidon2_absorb")
        K.check(
            lib.bt_poseidon2_absorb(K.ptr(state), K.ptr(cols), b, N, K.stream(dev)),
            "poseidon2 absorb",
        )
    return state


# ---------------------------------------------------------------------------
# Host scalar mirror (python ints): transcript and proof verification
# ---------------------------------------------------------------------------


def _sbox7_s(x):
    x2 = gl.sqr(x)
    return gl.mul(gl.sqr(x2), gl.mul(x2, x))


def _block_m4_s(x0, x1, x2, x3):
    t0 = gl.add(x0, x1)
    t1 = gl.add(x2, x3)
    t2 = gl.add(gl.add(x1, x1), t1)
    t3 = gl.add(gl.add(x3, x3), t0)
    t4 = gl.add(gl.add(gl.add(t1, t1), gl.add(t1, t1)), t3)
    t5 = gl.add(gl.add(gl.add(t0, t0), gl.add(t0, t0)), t2)
    return gl.add(t3, t5), t5, gl.add(t2, t4), t4


def _external_mds_s(s):
    blocks = [_block_m4_s(*s[4 * b : 4 * b + 4]) for b in range(3)]
    sums = [
        gl.add(gl.add(blocks[0][i], blocks[1][i]), blocks[2][i]) for i in range(4)
    ]
    return [gl.add(blocks[b][i], sums[i]) for b in range(3) for i in range(4)]


def _internal_mds_s(s):
    total = 0
    for v in s:
        total = gl.add(total, v)
    return [gl.add(gl.mul(s[i], DIAG[i]), total) for i in range(12)]


def poseidon2_permutation_host(state: list) -> list:
    s = _external_mds_s(list(state))
    for r in range(4):
        s = _external_mds_s([_sbox7_s(gl.add(v, RC[r][i])) for i, v in enumerate(s)])
    for r in range(4, 26):
        s[0] = _sbox7_s(gl.add(s[0], RC[r][0]))
        s = _internal_mds_s(s)
    for r in range(26, 30):
        s = _external_mds_s([_sbox7_s(gl.add(v, RC[r][i])) for i, v in enumerate(s)])
    return s


class Poseidon2SpongeHost:
    """Overwrite-mode sponge over python ints (path checks), rate 8; a
    subclass swaps the permutation."""

    _PERMUTATION = staticmethod(poseidon2_permutation_host)

    def __init__(self):
        self.state = [0] * 12
        self.buffer = []

    def absorb(self, values):
        self.buffer.extend(int(v) for v in values)
        while len(self.buffer) >= 8:
            chunk, self.buffer = self.buffer[:8], self.buffer[8:]
            self.state[:8] = chunk
            self.state = self._PERMUTATION(self.state)

    def finalize(self, n=4):
        if self.buffer:
            self.state[: len(self.buffer)] = self.buffer
            for i in range(len(self.buffer), 8):
                self.state[i] = 0
            self.state = self._PERMUTATION(self.state)
            self.buffer = []
        return self.state[:n]

    @classmethod
    def hash_leaf(cls, values, n=4):
        sp = cls()
        sp.absorb(values)
        return sp.finalize(n)

    @classmethod
    def hash_node(cls, left, right):
        sp = cls()
        sp.absorb(list(left) + list(right))
        return sp.finalize(4)
