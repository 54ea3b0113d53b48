"""Poseidon2 over BabyBear (width 16, x^7): batched tensors and host.

The JAX package's hashes/poseidon2_bb.py: the external matrix
circ(2*M4, M4, M4, M4) first, 4 full rounds, 13 partial rounds with the
internal matrix all-ones + diag(d), 4 full rounds. Merkle digests are 8
words: a leaf absorbs rate-8 overwrite-mode chunks, the last one
zero-padded; a node is the truncated permutation of left ‖ right.

Kernel B8 (csrc/poseidon2_bb.cu, replacing boojum_tpu/hashes/poseidon2_bb.py
_perm_kernel) carries three wrappers:
- `poseidon2_permutation_bb`: the permutation of (N, 16) states, what the
  Pallas kernel computes;
- `leaf_hash_bb`: the leaf sponge of a column-major stack, every chunk in
  one launch (the JAX package launches the permutation once per chunk),
  optionally over paired leaves (leaf j of a (B, N) oracle holds its
  columns at j and at j + N/2);
- `node_hash_bb`: the compression of two (M, 8) digest arrays.
A CUDA tensor launches the kernel; a CPU tensor runs the plain PyTorch
version below, the kernel's reference, used nowhere on the card. The host
mirror over python ints carries the transcript and path checks.
"""

from __future__ import annotations

import torch

from .. import kernels as K
from ..field import babybear as bb
from . import poseidon2_params as params

P = bb.P
WIDTH = params.BB_STATE_WIDTH
RATE = params.BB_RATE
DIGEST = 8
RC_EXT = [[int(v) for v in row] for row in params.BB_EXTERNAL_ROUND_CONSTANTS]
RC_INT = [int(v) for v in params.BB_INTERNAL_ROUND_CONSTANTS]
DIAG = [int(v) for v in params.BB_M_I_DIAGONAL]


# ---------------------------------------------------------------------------
# The round function over any add / double / mul (host ints, op counts)
# ---------------------------------------------------------------------------


def _sbox7(x, mul):
    x2 = mul(x, x)
    x3 = mul(x2, x)
    x4 = mul(x2, x2)
    return mul(x4, x3)


def _block_m4(x0, x1, x2, x3, add, double):
    """M4 = [[5,7,1,3],[4,6,1,1],[1,3,5,7],[1,1,4,6]] by an add/double chain."""
    t0 = add(x0, x1)
    t1 = add(x2, x3)
    t2 = add(double(x1), t1)
    t3 = add(double(x3), t0)
    t4 = add(double(double(t1)), t3)
    t5 = add(double(double(t0)), t2)
    return add(t3, t5), t5, add(t2, t4), t4


def _external(s, add, double):
    """circ(2*M4, M4, M4, M4) over 16 lanes."""
    blocks = [_block_m4(*s[4 * b : 4 * b + 4], add, double) for b in range(4)]
    sums = [add(add(blocks[0][i], blocks[1][i]), add(blocks[2][i], blocks[3][i]))
            for i in range(4)]
    return [add(blocks[b][i], sums[i]) for b in range(4) for i in range(4)]


def _permute(s, add, double, mul):
    s = _external(list(s), add, double)
    for r in range(8):
        if r == 4:
            for c in range(params.BB_NUM_PARTIAL_ROUNDS):
                s[0] = _sbox7(add(s[0], RC_INT[c]), mul)
                total = s[0]
                for v in s[1:]:
                    total = add(total, v)
                s = [add(mul(v, d), total) for v, d in zip(s, DIAG)]
        s = _external([_sbox7(add(v, RC_EXT[r][i]), mul) for i, v in enumerate(s)],
                      add, double)
    return s


def poseidon2_permutation_bb_host(state: list) -> list:
    """The permutation over 16 python ints."""
    if len(state) != WIDTH:
        raise ValueError(f"a state has {WIDTH} words")
    return _permute([int(x) % P for x in state], bb.add_s,
                    lambda a: bb.add_s(a, a), bb.mul_s)


def leaf_hash_bb_host(values) -> list:
    """Overwrite-mode sponge over a python int sequence -> 8 words."""
    state = [0] * WIDTH
    vals = [int(v) % P for v in values]
    for c in range(0, len(vals), RATE):
        chunk = vals[c : c + RATE]
        state[:RATE] = chunk + [0] * (RATE - len(chunk))
        state = poseidon2_permutation_bb_host(state)
    return state[:DIGEST]


def node_hash_bb_host(left, right) -> list:
    return poseidon2_permutation_bb_host(list(left) + list(right))[:DIGEST]


def permutation_op_counts() -> tuple[int, int]:
    """(field multiplies, field adds and doubles) of one permutation, as
    the kernel performs them; its entry to and exit from Montgomery form
    cost one multiply a word on top."""
    counts = [0, 0]

    def add(a, b):
        counts[1] += 1
        return 0

    def mul(a, b):
        counts[0] += 1
        return 0

    _permute([0] * WIDTH, add, lambda a: add(a, a), mul)
    return counts[0], counts[1]


# ---------------------------------------------------------------------------
# Plain PyTorch versions (int64 lanes, reduced lazily: every intermediate
# of the matrix layers stays below 2^40)
# ---------------------------------------------------------------------------


def _red(x):
    return x % P


def _sbox7_t(x):
    x2 = (x * x) % P
    x3 = (x2 * x) % P
    x4 = (x2 * x2) % P
    return (x4 * x3) % P


def _external_t(s):
    out = _external(s, lambda a, b: a + b, lambda a: a + a)
    return [_red(v) for v in out]


def permute_lanes(s: list) -> list:
    """The permutation over 16 same-shape int64 lane tensors of canonical
    words."""
    s = _external_t(s)
    for r in range(8):
        if r == 4:
            for c in range(params.BB_NUM_PARTIAL_ROUNDS):
                s[0] = _sbox7_t(_red(s[0] + RC_INT[c]))
                total = s[0]
                for v in s[1:]:
                    total = total + v
                s = [_red(v * d + total) for v, d in zip(s, DIAG)]
        s = _external_t([_sbox7_t(_red(v + RC_EXT[r][i])) for i, v in enumerate(s)])
    return s


def permutation_plain(state: torch.Tensor) -> torch.Tensor:
    """(N, 16) -> (N, 16)."""
    s = permute_lanes([state[:, i].to(torch.int64) for i in range(WIDTH)])
    return torch.stack(s, dim=1).to(state.dtype)


def _leaf_columns(cols: torch.Tensor, paired: bool) -> list:
    """The columns a leaf absorbs, in order: (B, M) as they are, or a paired
    (B, 2M) oracle's columns at j, then at j + M."""
    if not paired:
        return list(cols)
    M = cols.shape[1] // 2
    return [c[:M] for c in cols] + [c[M:] for c in cols]


def leaf_hash_plain(cols: torch.Tensor, paired: bool = False) -> torch.Tensor:
    absorbed = _leaf_columns(cols, paired)
    M = cols.shape[1] // 2 if paired else cols.shape[1]
    zero = torch.zeros(M, dtype=torch.int64, device=cols.device)
    s = [zero] * WIDTH
    for c0 in range(0, len(absorbed), RATE):
        chunk = [c.to(torch.int64) for c in absorbed[c0 : c0 + RATE]]
        s = permute_lanes(chunk + [zero] * (RATE - len(chunk)) + s[RATE:])
    return torch.stack(s[:DIGEST], dim=1).to(cols.dtype)


def node_hash_plain(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    s = permute_lanes([left[:, k].to(torch.int64) for k in range(DIGEST)]
                      + [right[:, k].to(torch.int64) for k in range(DIGEST)])
    return torch.stack(s[:DIGEST], dim=1).to(left.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers (B8)
# ---------------------------------------------------------------------------

_constants_set: set = set()


def _to_mont(v: int) -> int:
    return (v << 32) % P


def _library(dev: torch.device):
    """The B8 library with the Montgomery-form round constants and diagonal
    in the device's constant memory."""
    import ctypes

    lib = K.library("poseidon2_bb")
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _constants_set:
        words = ([_to_mont(v) for row in RC_EXT for v in row]
                 + [_to_mont(v) for v in RC_INT] + [_to_mont(v) for v in DIAG])
        arr = (ctypes.c_uint32 * len(words))(*words)
        with torch.cuda.device(idx):
            K.check(lib.bt_poseidon2_bb_set_constants(arr, len(words)),
                    "poseidon2_bb constants")
        _constants_set.add(idx)
    return lib


def poseidon2_permutation_bb(state: torch.Tensor) -> torch.Tensor:
    """The permutation of each row of an (N, 16) int32 state stack."""
    K.require(state, "poseidon2_permutation_bb state", dtype=torch.int32)
    if state.dim() != 2 or state.shape[1] != WIDTH:
        raise ValueError(f"expected (N, 16) states, got {tuple(state.shape)}")
    dev = K.same_device(state)
    if dev.type == "cpu":
        return permutation_plain(state)
    out = torch.empty_like(state)
    lib = _library(dev)
    with torch.cuda.device(dev):
        K.count("poseidon2_bb_permute")
        K.check(lib.bt_poseidon2_bb_permute(K.ptr(state), state.shape[0], K.ptr(out),
                                            K.stream(dev)),
                "poseidon2_bb permutation")
    return out


def leaf_hash_bb(cols: torch.Tensor, paired: bool = False) -> torch.Tensor:
    """Leaf digests of a (B, M) int32 column-major stack: leaf j absorbs
    cols[:, j]. With `paired`, cols is a (B, N) oracle and leaf j < N/2
    absorbs cols[:, j] then cols[:, j + N/2]. Returns (leaves, 8)."""
    K.require(cols, "leaf_hash_bb cols", dtype=torch.int32)
    if cols.dim() != 2 or cols.shape[0] < 1 or (paired and cols.shape[1] % 2):
        raise ValueError(f"leaf_hash_bb: bad column stack {tuple(cols.shape)}")
    dev = K.same_device(cols)
    if dev.type == "cpu":
        return leaf_hash_plain(cols, paired)
    B, N = cols.shape
    M = N // 2 if paired else N
    out = torch.empty((M, DIGEST), dtype=torch.int32, device=dev)
    lib = _library(dev)
    with torch.cuda.device(dev):
        K.count("poseidon2_bb_leaf")
        K.check(lib.bt_poseidon2_bb_leaf(K.ptr(cols), B, 2 if paired else 1, N, M, M,
                                         K.ptr(out), K.stream(dev)),
                "poseidon2_bb leaf hash")
    return out


def _require_digests(t, what, M=None):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32 words")
    if t.dim() != 2 or t.shape[1] != DIGEST or t.stride(1) != 1 or (
            M is not None and t.shape[0] != M):
        raise ValueError(f"{what}: expected (M, 8) digests with unit column stride")


def node_hash_bb(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """(M, 8) x (M, 8) -> (M, 8): the first 8 words of the permutation of
    left ‖ right. Rows may be strided (a layer's even and odd rows)."""
    _require_digests(left, "node_hash_bb left")
    _require_digests(right, "node_hash_bb right", left.shape[0])
    dev = K.same_device(left, right)
    if dev.type == "cpu":
        return node_hash_plain(left, right)
    M = left.shape[0]
    out = torch.empty((M, DIGEST), dtype=torch.int32, device=dev)
    lib = _library(dev)
    with torch.cuda.device(dev):
        K.count("poseidon2_bb_node")
        K.check(lib.bt_poseidon2_bb_node(K.ptr(left), left.stride(0), K.ptr(right),
                                         right.stride(0), M, K.ptr(out), K.stream(dev)),
                "poseidon2_bb node hash")
    return out


def node_layer_bb(layer: torch.Tensor) -> torch.Tensor:
    """One Merkle layer up: (2M, 8) -> (M, 8), parent i of children 2i, 2i+1."""
    return node_hash_bb(layer[0::2], layer[1::2])
