#!/usr/bin/env python3
"""Smoke test of boojum_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its seconds:
  1. the card's name and power limit, and its 32-bit integer issue rate
     (nvidia-smi, torch.cuda);
  2. the build of every CUDA kernel (one nvcc per source, all at once), and
     of the native witness resolver (native/resolver.cpp, g++), each with
     its seconds;
  3. every kernel against its plain PyTorch version on the card, word for
     word (tolerance 0: every result is an exact field element), at the
     shapes each 2^20 or 2^16 prove below gives it (fma; sha256 with LDE
     and quotient cosets at 8 and the sweep's specialized lookup terms;
     general-purpose-column lookups with the sweep's general lookup terms;
     witness columns with the sweep's witness loads), and the sweep
     through each of its standalone entries (cp_quotient, lookup_quotient,
     lookup_quotient_general, gate_terms_fn), each with its time, the plain
     version's time and its bound; at the three 2^20 paths, which stream
     their commits, kernel B4 too: the bare permutation of the (N, 12)
     sponge states and the absorb of the widest column block a streamed
     commit gives it; and kernel B8 (BabyBear Poseidon2) at the BabyBear fma
     and xor4 2^20 proves' shapes: the leaf sponge of the widest oracle
     (paired leaves), the node compression of the widest layer and the bare
     permutation of as many (N, 16) states as that oracle has leaves; the
     inverse NTT (B2) also at each prove's quotient row of Q·n words (the
     one row the prover interpolates the quotient from); the FRI fold (B7)
     twice a path: its first oracle (one launch, the schedule's first entry
     from the LDE length) and its whole chain (every entry of the
     schedule, one launch each, at its size); and the forward
     and inverse NTT (B1-B3) at 2^17, 2^21, 2^22 and 2^23, where their pass
     plans change. The keccak256 2^18 path gives every kernel its shapes,
     and so does the secp256k1 ladder at 2^18 (the same oracle widths, its
     own gate programs in B6); blake2s at 2^17 has those widths too, so
     only the sweep (B6), whose gate programs differ, is checked again
     there; B7 also at phase 18's schedule [5, 4, 3] from 2^19 points,
     whose entries of 5 and 4 rounds split into two launches each (the
     second reading the first table at a stride); and gate_terms_fn
     at three programs no path runs at once: the byte tri-add, the u32
     fma and a 12×12 matrix gate, each alone over 2^18 rows of sha256's
     columns. The recursion circuit of phase 19 gives every kernel its
     shapes at 2^15 rows (130 witness and 138 setup columns, B6 with the
     flattened Poseidon2 gate's program, read from global memory), and
     gate_terms_fn runs the flattened Poseidon2 and legacy Poseidon gates
     each alone over 2^18 rows of 130 copy and 8 constant columns. The bound of the Goldilocks rows is the busier of the
     FMA and ALU pipes, priced by the SASS of each field operation, for the
     lesser of the plain version's operations and the kernel's own. Each
     row's launches_per_call is the wrapper's count over its first call;
     a fold row fails unless that is its schedule's count;
  4. small circuits set up and proved on the card and on the CPU: fma at
     2^10 (also under the poseidon, blake2s and keccak256 transcripts), the
     xor4 lookup circuit at 2^9, sha256(b"abc") at 2^14, the
     general-lookup circuit at 2^9, the witness-column circuit at 2^5 and
     the gate zoo (every gate of cs/gates/simple.py and u32.py) at 2^9,
     and over BabyBear the fma chain (also under blake2s_babybear) and the
     xor4 lookup circuit at 2^10 and the toy round function
     (circuits.build_poseidon_rf, the JAX tests' 48 rounds) at 2^8; then
     the 130-column circuits: the Poseidon2 and
     legacy Poseidon flat chains (8 permutations, 16 rows),
     tests/test_queue.py's queue round trip (2^12 rows) and the recursion
     circuit over the Fibonacci proof at 2^10 under the Poseidon2 and the
     legacy Poseidon transcripts.
     The two setup caps of each must be equal, the two proofs the same JSON
     text, and the port's verifier must accept (a BabyBear proof: the
     quotient identity at z and every query's Merkle paths). The CPU sides
     of the Goldilocks circuits, the slowest part, run in two child
     processes started before phase 3 (sha256 "abc", then the 130-column
     circuits, in one, whose pairs are checked after phase 8; the rest in
     the other);
  5. the bench fma-chain circuit (16 copy columns, 6 constant columns,
     degree 3; LDE 4, cap 16, 50 queries, no PoW, final degree 16)
     synthesized, set up, proved and verified at 2^20 rows. Its commits
     pass the 1.5 GiB stream threshold, so the prover streams them, as the
     JAX package does. The launch counts go to 0 before synthesis and are
     read after verification; every kernel of the path must have launched
     on the prove (the absorb only on a streamed prove; the bare
     permutation is on no prove);
  6. where the time of that prove goes: a warm prove (per-round seconds),
     then one under torch.profiler, tracing the card's activity only (a
     trace of every host op costs tens of seconds a prove to parse), read
     from the tracer's raw device events (its per-op tables cost as much
     to build). Device
     time is grouped into the port's CUDA kernels (by kernel), the plain
     PyTorch work around them (by kernel) and copies; the idle share is
     1 - device busy / wall. One JSON line;
  7. the slice: bench.py's headline, sha256 over 8 KiB (60 copy columns,
     8 constant columns, degree 7, width-4 x8 specialized lookups; LDE 8,
     cap 16, 50 queries, no PoW, final degree 16) at 2^16 rows, as phase 5
     with its own launch counts (its commits stay materialized: no absorb
     launch), and the circuit's digest against hashlib;
  8. the same profile as phase 6 for the sha256 prove, on its own line;
  9. general-purpose-column lookups (the JAX package's
     tests/test_lookup_general.py circuit: 8 copy, 0 witness, 6 constant
     columns, degree 4, width-3 lookups on marker rows, xor4 and 4-bit
     range tables) grown to 2^20 rows, with sha256's proof config, driven
     as phase 5 with the public input checked against the host's value,
     then profiled as phase 6;
 10. the same for the witness-column circuit (tests/test_witness_columns.py:
     8 copy, 4 witness, 6 constant columns, degree 4) at 2^20 rows;
 11. (run right after phase 9, before phase 10) streamed against
     materialized on phase 9's circuit: proved by the
     default rule, with every commit streamed (threshold 0, setup too) and
     with none streamed (threshold math.inf), a warm prove of each with its
     peak device memory; the three proofs must be the same JSON text and
     each accepted by the verifier;
 12. the BabyBear prover (prover/prover_bb.py): the fma chain synthesized
     over BabyBear at 2^20 rows with the fma config, driven as phase 5 (B8
     must launch on the prove, no Goldilocks kernel anywhere on the path),
     checked by the quotient identity at z, every query's Merkle paths and
     the public input against the host's own run of the chain, then
     profiled as phase 6;
 13. the same for the xor4 lookup circuit grown to 2^20 rows, with
     sha256's proof config (LDE 8, cap 16, 50 queries, final degree 16),
     the public input checked against the accumulator's host value;
 14. the BabyBear mini-STARK (prover/bb_prover.py) at 2^20 rows, proved on
     the card and accepted by its verifier, B8 launched;
 15. keccak256 (the JAX package's tests/test_keccak.py circuit at sha256's
     geometry and lookups: bytes through the 8-bit xor and and tables,
     rotations through byte-split tables) of a message that fills 2^18
     rows, with sha256's proof config, driven as phase 5 (the prover's rule
     streams its commits at LDE 8, which the phase checks), the digest
     checked against hashes/keccak_host.py, then profiled as phase 6;
 16. the same for blake2s at 2^17 rows (its additions on the byte tri-add
     gate), the digest checked against hashlib;
 17. the secp256k1 double-and-add ladder (circuits.secp256k1_ladder, the
     inner loop of era's ecrecover: non-native secp256k1 arithmetic over
     16-bit limbs at sha256's geometry and lookups) with as many steps as
     fill 2^18 rows, sha256's proof config, driven as phase 15 (streamed),
     its affine result checked against [k]G computed on the host, then
     profiled as phase 6.
     The three circuits of phases 15-17 are synthesized in child processes
     started before phase 3, each timing its own synthesis, so that their
     seconds of Python overlap the card's phases;
 18. (run right after phase 8) phase 7's sha256 assembly set up, proved
     and verified twice more, as phase 5, with the protocol options: the
     keccak256 transcript with the explicit FRI schedule [5, 4, 3] (entries
     past the fold kernel's three rounds a launch), and the blake2s
     transcript with quotient_degree 16 (the sweep over 16 cosets against
     8 committed); the key must carry the options, B7 launch once per
     launch its schedule splits into and B6 once per coset;
 19. a proof of a proof: the recursion circuit (Era's recursion layer: 130
     copy columns, 8 constant columns, degree 7, a flattened Poseidon2
     permutation a row) verifying phase 7's sha256 proof, synthesized by a
     child process started right after phase 7 from that proof's VK and
     proof JSON, driven as phase 5 with sha256's proof config (LDE 8: its
     gates' quotient degree is 8), its public inputs checked against the
     inner proof's, then profiled as phase 6;
 20. (run right after phase 8) one setup, many witnesses, as Era's prover
     runs: a child process started before phase 3 synthesizes phase 7's
     sha256 circuit under SETUP_CS_CONFIG (placement, no witness) and
     sha256 over two further 8 KiB messages drawn from a seed, pickling
     each witness vector with its digest places; the card sets up the
     setup-only assembly (its VK must be phase 7's) and proves each
     witness taken over by `with_external_witness`, each proof verified
     under phase 7's VK, its digest read from the witness vector equal to
     hashlib's, and the witness caps (phase 7's too) all different; the
     last prove profiled as phase 6.

Synthesis goes through the default witness resolver: the native tape over
Goldilocks, the Python resolver over BabyBear; each synthesis line and
child names its resolver and seconds. The 2^20 circuits of phases 5, 9,
10, 12 and 13 are synthesized by child processes started after phase 3,
beside phase 4, as phases 15-17 are before it; all five end before phase
5, so that no timed prove of phases 5-8 and 20 shares the host with
them. Every Goldilocks path's prove must
launch B6 once per quotient coset and B7 once per launch of its schedule.
Prints the twelve profile lines, the
kernel table as one JSON line, the card line, and as the last line
{"ok": true, "device": {...}}. Exits non-zero, with no result, if any phase
fails, if no CUDA device is available, or if the package is missing.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

LOG_N = 20  # the fma chain: the Era main-VM trace length
SHA_BYTES = 8192  # bench.py's sha256 message; pads to 2^16 rows
FMA_PATH = f"fma 2^{LOG_N}"
SHA_LOG_N = 16
SHA_PATH = f"sha256 {SHA_BYTES} B, 2^{SHA_LOG_N}"
GEN_PATH = f"general lookups 2^{LOG_N}"
WIT_PATH = f"witness columns 2^{LOG_N}"
BB_FMA_PATH = f"babybear fma 2^{LOG_N}"
BB_XOR_PATH = f"babybear xor4 2^{LOG_N}"
BB_MINI_PATH = f"babybear mini-STARK 2^{LOG_N}"
HASH_LOG_N = 18  # keccak256's tables alone take 2^17 rows
BLAKE_LOG_N = 17  # blake2s at the size of its CPU parity check
KECCAK_PATH = f"keccak256 2^{HASH_LOG_N}"
BLAKE_PATH = f"blake2s 2^{BLAKE_LOG_N}"
GATES_PATH = f"gate_terms_fn alone, 2^{HASH_LOG_N}"
LADDER_LOG_N = 18
LADDER_PATH = f"secp256k1 ladder 2^{LADDER_LOG_N}"
REC_LOG_N = 15  # the recursion circuit over one sha256 8 KiB proof fills it
REC_PATH = f"recursion over {SHA_PATH}, 2^{REC_LOG_N}"
REC_GATES_PATH = f"gate_terms_fn alone, 130 columns, 2^{HASH_LOG_N}"
# phase 18: phase 7's sha256 assembly under the protocol options
SPLIT_SCHEDULE = [5, 4, 3]  # entries past fri.MAX_FOLD_K split into launches
SPLIT_PATH = f"{SHA_PATH}, keccak256 transcript, schedule {SPLIT_SCHEDULE}"
Q16_PATH = f"{SHA_PATH}, blake2s transcript, quotient degree 16"
# phase 20: one setup of the sha256 circuit, proofs of further witnesses
REWITNESS_PATH = f"{SHA_PATH}, setup-only synthesis and external witnesses"
REWITNESS_COUNT = 2
REWITNESS_SEED = 2026
TRANSCRIPT_KINDS = ("poseidon", "blake2s", "keccak256")  # phase 4's fma 2^10 pairs
# the NTT (B1-B3) at the sizes where its pass plans change
NTT_SIZES = (17, 21, 22, 23)
SIZES_PATH = "NTT sizes 2^17-2^23"
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, published
# 32-bit integer multiply-add and add issue per SM per clock on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput); times the SM count and the card's maximum SM clock.
INT32_PER_SM_CLOCK = 64
# The Goldilocks kernels (B1-B7) count by pipe, as B8 does: multiply-adds
# issue to the FMA pipe, adds, logic, shifts, compares and selects to the ALU
# pipe, each at INT32_PER_SM_CLOCK, so the bound is the busier pipe. The
# work is the plain version's field operations, each priced (FMA, ALU) at
# the cheapest sequence of csrc/goldilocks.cuh that does it, counted in
# the SASS nvcc makes for sm_90a (scripts/torch_kernel_sass.py): a
# multiply at mul_lazy (a product left below 2^64),
# an add, subtract or negation at wadd (an add into a 96-bit accumulator,
# reduced later). One exception to the plain count: a product by a
# power-of-two constant, which the plain Poseidon2 makes 12 times in each
# of its 22 internal layers (the diagonal of M_I), is priced as the shift
# and reduction any implementation needs (shift_add_reduce_lazy less its
# wadd), since none needs a general multiply there; B4 and B5 count it so.
# Where a kernel does the same function in fewer operations (the NTT leaves
# out products by 1, B6 sums products unreduced), its own count, priced
# the same way, is the bound instead (bound_own_ms beside bound_plain_ms).
GL_MUL = (8.5, 15.0)
GL_ADD = (0.125, 2.875)
GL_SHIFT = (1.875, 6.125)
# The canonical sequences (every result in [0, p)) that B1-B3, B6 and B7
# run: gl::mul, gl::add, gl::sub. A row's bound_canonical_ms prices the
# same work with them: how near the kernel's own arithmetic runs to issue.
GL_MUL_CANON = (9.5, 20.0)
GL_ADD_CANON = (1.0, 7.0)
GL_SUB_CANON = (2.0, 4.0)
# The sequences of B6's own arithmetic (csrc/quotient_sweep.cu), for its
# bound_own_ms: add_lazy and sub_lazy (any words below 2^64), the lazy
# GF(p^2) product, a 128-bit product added into an accumulator (acc_mac),
# a word added into one (acc_add) and an accumulator's reduction.
GL_SWEEP_OPS = {"mul_lazy": GL_MUL, "sub": GL_SUB_CANON,
                "add_lazy": (2.125, 10.0), "sub_lazy": (2.25, 10.0),
                "ext_mul_lazy": (29.75, 56.875), "acc_mac": (5.5, 6.25),
                "acc_add": (0.5, 4.25), "reduce_acc_lazy": (2.0, 14.0)}
# The sequences of B7's own arithmetic (csrc/fri_fold.cu), for its
# bound_own_ms: one pair of the first round (canonical words) and of a later
# round (lazy words), four reductions each; mul_lazy squares 1/x, gl::mul
# makes each output canonical times 2^-k.
GL_FOLD_OPS = {"fold_pair_first": (65.25, 94.375), "fold_pair_lazy": (65.625, 106.5),
               "mul_lazy": GL_MUL, "mul": GL_MUL_CANON}
# B8 (csrc/poseidon2_bb.cu) counts by pipe: multiply-adds issue to the FMA
# pipe, adds and min/max to the ALU pipe, each at INT32_PER_SM_CLOCK, so its
# bound is the busier pipe. A Montgomery product is three multiply-adds (a
# wide multiply, a low multiply, a wide multiply-add) and two ALU
# instructions (the conditional subtract: a subtract and an unsigned min);
# an add is two ALU instructions (the add and the min). Estimates from the
# source's sequences, not a count of the compiled code.
BB_MUL_FMA, BB_MUL_ALU, BB_ADD_ALU = 3, 2, 2

GL_POSEIDON2 = ("poseidon2_permute", "poseidon2_absorb", "poseidon2_leaf", "poseidon2_node")
# CUDA kernel function -> the port's kernel it belongs to (phase 6)
PORT_FUNCTIONS = {
    "dif_pass": "ntt_forward/ntt_lde", "dit_pass": "ntt_inverse",
    "leaf_hash": "poseidon2_leaf", "node_hash": "poseidon2_node",
    "permute_batch": "poseidon2_permute", "absorb_block": "poseidon2_absorb",
    "sweep": "quotient_sweep", "fold_oracle": "fri_fold",
    "permute_bb": "poseidon2_bb_permute", "leaf_bb": "poseidon2_bb_leaf",
    "node_bb": "poseidon2_bb_node",
}
# entries the CUDA tracer adds for its own buffers, not work of the prove
PROFILER_MARKERS = ("Command Buffer Full", "Activity Buffer Request")


def log(msg: str) -> None:
    print(msg, flush=True)


class FieldOpCounter:
    """Counts the field multiplies, adds and subtracts a plain version
    performs, by wrapping the four primitives of field/goldilocks.py; with
    `shifts`, a product by a power-of-two python int counts as a shift."""

    def __init__(self, gf, shifts: bool = False):
        self.gf = gf
        self.count_shifts = shifts
        self.muls = self.adds = self.subs = self.shifts = 0

    def __enter__(self):
        gf = self.gf
        self.saved = {k: getattr(gf, k) for k in ("mul", "add", "sub", "neg")}

        def wrap(name, field):
            fn = self.saved[name]

            def counted(*args):
                out = fn(*args)
                b = args[-1]
                kind = field
                if (field == "muls" and self.count_shifts and isinstance(b, int)
                        and b > 0 and b & (b - 1) == 0):
                    kind = "shifts"
                setattr(self, kind, getattr(self, kind) + out.numel())
                return out

            return counted

        gf.mul = wrap("mul", "muls")
        gf.add = wrap("add", "adds")
        for k in ("sub", "neg"):
            setattr(gf, k, wrap(k, "subs"))
        return self

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(self.gf, k, fn)

    def pipe_ops(self, canonical: bool = False) -> float:
        """Instructions of the busier pipe (FMA or ALU), at the cheapest or
        the canonical prices."""
        muls = self.muls
        mul, add, sub = ((GL_MUL_CANON, GL_ADD_CANON, GL_SUB_CANON) if canonical
                         else (GL_MUL, GL_ADD, GL_ADD))
        return max(muls * mul[k] + self.adds * add[k] + self.subs * sub[k]
                   + self.shifts * GL_SHIFT[k] for k in (0, 1))


def ntt_kernel_muls(log_n: int, inverse: bool = False) -> int:
    """General multiplies the NTT kernel makes per row of 2^log_n words,
    forward coset scale aside: each pass's butterflies, less the products by
    1 the round with the pass's lowest bits leaves out (the forward's last,
    the inverse's first), plus a strided pass's four-step twiddles; the
    inverse in one pass adds its 1/n. The plain versions make log_n *
    2^(log_n - 1), the inverse 2^log_n more for its 1/n."""
    from boojum_tpu_torch.ntt.ntt import forward_pass_plan

    n, plan = 1 << log_n, forward_pass_plan(log_n)
    muls = n * (len(plan) - 1) + (n if inverse and len(plan) == 1 else 0)
    for k in plan:
        rb = min(k, 3)
        muls += (n >> k) * (k * (1 << (k - 1)) - ((1 << rb) - 1) * (1 << (k - rb)))
    return muls


def ntt_kernel_ops(log_n: int, transforms: int, inverse: bool = False,
                   scaled: bool = False) -> float:
    """Busier-pipe instructions of `transforms` NTTs of 2^log_n words as the
    kernel makes them: its multiplies (`ntt_kernel_muls`, a coset scale's
    n more where `scaled`) and the butterflies' log_n * 2^(log_n - 1) adds
    and as many subtracts, at the cheapest prices."""
    n = 1 << log_n
    muls = transforms * (ntt_kernel_muls(log_n, inverse) + (n if scaled else 0))
    adds = transforms * log_n * (n // 2)
    return max(muls * GL_MUL[k] + 2 * adds * GL_ADD[k] for k in (0, 1))


def sweep_kernel_ops(plan, zhinv: bool) -> float:
    """Busier-pipe instructions of a row of B6's own arithmetic: the
    kernel's operations (quotient_sweep.kernel_ops) at GL_SWEEP_OPS."""
    from boojum_tpu_torch.prover import quotient_sweep as qs

    ops = qs.kernel_ops(plan, zhinv)
    return max(sum(v * GL_SWEEP_OPS[k][pipe] for k, v in ops.items()) for pipe in (0, 1))


def own_ops(fn, ops: float):
    """Mark a case with the busier pipe's instructions of the kernel's own
    arithmetic for the same function (the NTT, B6)."""
    fn.own_ops = ops
    return fn


def fold_rounds(fn, ops: float, nbytes: int, launches: int):
    """Mark a fold case (B7) with the count of the same rounds done one at a
    time by fold_once_plain: the busier pipe's instructions and the bytes
    (each round's table read), for its bound_rounds_ms; and the launches its
    schedule needs, which one call must make."""
    fn.rounds_bound = (ops, nbytes)
    fn.schedule_launches = launches
    return fn


def fold_kernel_ops(N: int, k: int, max_k: int) -> float:
    """Busier-pipe instructions of B7's launches for k rounds from N points
    (a launch takes at most max_k): each launch's first-round pairs and
    later pairs, a squaring of 1/x for each later pair (and a later launch
    of a split entry squares its first table words once a round before),
    two products by 2^-k an output, at GL_FOLD_OPS."""
    ops = {k_: 0 for k_ in GL_FOLD_OPS}
    done = 0
    while done < k:
        kc = min(max_k, k - done)
        size = N >> done
        later = sum(size >> (r + 1) for r in range(1, kc))
        ops["fold_pair_first"] += size // 2
        ops["fold_pair_lazy"] += later
        ops["mul_lazy"] += later + done * (size // 2)
        ops["mul"] += 2 * (size >> kc)
        done += kc
    return max(sum(v * GL_FOLD_OPS[k_][pipe] for k_, v in ops.items()) for pipe in (0, 1))


def fold_rounds_ops(torch, gf, fri, N: int, k: int) -> float:
    """Busier-pipe instructions of k rounds of fold_once_plain from N points:
    one pair's field operations, counted, times the k rounds' pairs."""
    with FieldOpCounter(gf) as ops:
        x = torch.zeros(2, dtype=torch.int64)
        fri.fold_once_plain(x, x, (3, 5), x[:1])
    pairs = sum(N >> (r + 1) for r in range(k))
    ops.muls, ops.adds, ops.subs = (v * pairs for v in (ops.muls, ops.adds, ops.subs))
    return ops.pipe_ops()


def timed(torch, fn, reps: int, warm_up: bool = True) -> float:
    """Mean milliseconds of fn() over reps runs, by CUDA events, after one
    untimed run unless the caller has just run fn."""
    if warm_up:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(gf, a, b) -> int:
    """Largest |a - b| over the words (as unsigned integers: 64-bit
    Goldilocks words, 32-bit BabyBear words)."""
    if a.shape == b.shape and a.equal(b):  # on the device, before any copy
        return 0
    if a.element_size() == b.element_size() == 4:
        na, nb = a.cpu().numpy().ravel(), b.cpu().numpy().ravel()
    else:
        na, nb = gf.to_numpy(a).ravel(), gf.to_numpy(b).ravel()
    bad = na != nb
    if not bad.any():
        return 0
    return max(abs(int(x) - int(y)) for x, y in zip(na[bad], nb[bad]))


def nvidia_smi(query: str, fmt: str = "csv,noheader") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def kernel_parity(torch, paths, sweep_paths, bb_paths, int_ops_per_s: float) -> list:
    """Every kernel against its plain version at the shapes each prove path
    gives it. `paths` (Goldilocks) and `bb_paths` (BabyBear) hold (path, an
    assembly of the path's circuit at a small size, log2 of the path's
    rows, its proof config); `sweep_paths` (path, assembly, log2 rows) the
    paths whose oracles have the widths of one in `paths`, where only the
    sweep's gate programs differ: only B6 runs at their shapes."""
    import numpy as np

    from boojum_tpu_torch import kernels as K
    from boojum_tpu_torch.circuits import RECURSION_GEOMETRY, SHA256_GEOMETRY
    from boojum_tpu_torch.cs.gates import (
        ByteTriAddGate, MatrixMultiplicationGate, Poseidon2FlattenedGate, PoseidonFlattenedGate,
        U32FmaGate,
    )
    from boojum_tpu_torch.field import babybear as bb
    from boojum_tpu_torch.field import goldilocks as gf
    from boojum_tpu_torch.hashes import poseidon2 as p2
    from boojum_tpu_torch.hashes import poseidon2_bb as p2bb
    from boojum_tpu_torch.ntt import ntt
    from boojum_tpu_torch.prover import fri, quotient_sweep as qs, stages_bb
    from boojum_tpu_torch.prover.layout import OracleLayout, chunk_columns
    from boojum_tpu_torch.prover.setup import build_selector_tree, quotient_degree_for
    from boojum_tpu_torch.prover.streaming import COL_BLOCK, use_streamed_lde

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    w = 8  # bytes per word

    def rand(*shape):
        x = torch.randint(-(2**63), 2**63 - 1, shape, generator=gen,
                          dtype=torch.int64, device=dev)
        return torch.where((x ^ -(2**63)) >= (gf.P ^ 2**63), x - gf.P_I64, x)

    def bb_rand(*shape):
        return torch.randint(0, bb.P, shape, generator=gen, dtype=torch.int32, device=dev)

    core_muls, core_adds = p2bb.permutation_op_counts()

    def b8_ops(perms, conversions):
        """The busier pipe's instructions for `perms` permutations and
        `conversions` words into or out of Montgomery form (a multiply each)."""
        muls = perms * core_muls + conversions
        return max(muls * BB_MUL_FMA, muls * BB_MUL_ALU + perms * core_adds * BB_ADD_ALU)

    def bb_cases(asm, log_n, L):
        """(name, kernel call, plain call, bytes moved, shape, 32-bit integer
        instructions of the busier pipe) of B8 at the shapes the BabyBear prove of `asm`'s circuit at
        2^log_n rows gives it: the leaf sponge of its widest oracle over
        paired leaves (N/2 leaves of 2B words each), the node compression of
        a tree's widest layer, and the bare permutation of as many states as
        that oracle has leaves."""
        N = (1 << log_n) * L
        M = N // 2
        tree, sel_paths = build_selector_tree(asm.gates)
        Q = quotient_degree_for(asm, tree)
        Ct = asm.num_copy_cols_total
        chunks = chunk_columns(Ct, asm.geometry.max_allowed_constraint_degree)
        ctx = stages_bb.SweepContext(asm, sel_paths, [1] * Ct, chunks)
        lk = int(ctx.lookups)
        widths = {"witness": Ct + ctx.W + lk,
                  "setup": Ct + ctx.Kc + lk * (ctx.width + 1),
                  "stage-2": 4 * len(chunks) + lk * 4 * (ctx.R + 1),
                  "quotient": 4 * Q}
        oracle, B = max(widths.items(), key=lambda kv: kv[1])
        cols, layer, states = bb_rand(B, N), bb_rand(M, 8), bb_rand(M, 16)
        perms_a_leaf = -(-2 * B // 8)
        return [
            ("poseidon2_bb_permute",
             lambda: p2bb.poseidon2_permutation_bb(states),
             lambda: p2bb.permutation_plain(states),
             4 * 32 * M, f"({M}, 16) states", b8_ops(M, 32 * M)),
            ("poseidon2_bb_leaf",
             lambda: p2bb.leaf_hash_bb(cols, paired=True),
             lambda: p2bb.leaf_hash_plain(cols, paired=True),
             4 * (B * N + 8 * M), f"{oracle} oracle ({B}, {N}) -> {M} paired leaves",
             b8_ops(M * perms_a_leaf, M * (8 * perms_a_leaf + 8))),
            ("poseidon2_bb_node",
             lambda: p2bb.node_layer_bb(layer),
             lambda: p2bb.node_hash_plain(layer[0::2], layer[1::2]),
             4 * (8 * M + 4 * M), f"({M}, 8) -> ({M // 2}, 8)", b8_ops(M // 2, 12 * M)),
        ]

    def fold_cases(n, N, final_degree, explicit=None):
        """B7's two rows of a path whose LDE has N points: the first oracle
        (the schedule's first entry from N points) and the whole chain
        (every entry, each from the last one's result), with the path's
        entry tables and sub-challenges ch, ch^2, ... of arbitrary
        challenges; `explicit`: the path's configured schedule. The bytes:
        each entry's codeword in, result out and first-round table; of the
        one-round-at-a-time count, every round's table."""
        schedule = fri.fold_schedule(n, final_degree, explicit)
        tables = fri.fold_entry_tables(N.bit_length() - 1, schedule, dev)
        subs = [fri.sub_challenges((3 + r, 5 + r), k) for r, k in enumerate(schedule)]
        c0, c1 = rand(N), rand(N)

        def chain(fold, entries):
            a, b = c0, c1
            for sub, t in zip(subs[:entries], tables):
                a, b = fold(a, b, sub, t)
            return a, b  # timed without a stack of the two

        out = []
        for label, entries in (("first oracle", 1), ("chain", len(schedule))):
            nbytes = rounds_bytes = rounds_ops = kernel_ops = launches = 0
            size = N
            for k in schedule[:entries]:
                nbytes += w * (2 * size + 2 * (size >> k) + size // 2)
                rounds_bytes += w * (2 * size + 2 * (size >> k)
                                     + sum(size >> (r + 1) for r in range(k)))
                rounds_ops += fold_rounds_ops(torch, gf, fri, size, k)
                kernel_ops += fold_kernel_ops(size, k, fri.MAX_FOLD_K)
                launches += -(-k // fri.MAX_FOLD_K)
                size >>= k
            ks = ",".join(map(str, schedule[:entries]))
            out.append(("fri_fold",
                        own_ops(fold_rounds(lambda e=entries: chain(fri.fold_oracle, e),
                                            rounds_ops, rounds_bytes, launches),
                                kernel_ops),
                        lambda e=entries: chain(fri.fold_oracle_plain, e),
                        nbytes, f"{label}: {N} -> {size} (k = {ks})"))
        return out

    def path_cases(asm, log_n, cfg):
        """(name, kernel call, plain call, bytes moved, shape) of each kernel
        on random inputs of the shapes the prove of `asm`'s circuit at 2^log_n
        rows with proof config `cfg` gives it: the widest call of each kernel
        on the prove (the witness oracle's commit for the inverse NTT and
        LDE, and for the leaf hash where the prover materializes, else the
        setup's commit; the setup oracle's coset evaluation for the forward
        NTT; the FRI fold's first oracle and its chain; where the prover
        streams, its widest absorbed block and the (N, 12) sponge states
        for B4)."""
        n = 1 << log_n
        L = cfg.fri_lde_factor
        N = n * L
        tree, sel_paths = build_selector_tree(asm.gates)
        Q = quotient_degree_for(asm, tree)
        plan, sweep_args, sweep_row = sweep_case(asm, log_n)
        Cw, Cs, C2 = plan.num_wit_rows, plan.num_setup_cols, plan.num_s2_rows
        wit, setup_m = sweep_args[:2]
        scale_row = ntt.lde_scale_rows(log_n, Q, dev)[1]
        layout = OracleLayout.for_assembly(asm, sel_paths)
        streams = use_streamed_lde(layout.streamed_columns_estimate(Q, L), N)
        # the widest leaf-hash commit: the witness's, where the prover
        # materializes, else the setup's; where both stream, the first FRI
        # oracle's, 2^(k+1) words a leaf
        Cl, Nl = (Cs if streams else Cw), N
        if streams and use_streamed_lde(Cs, N):
            k0 = fri.fold_schedule(n, cfg.fri_final_degree)[0]
            Cl, Nl = 2 << k0, N >> k0
        leaves, layer = rand(Cl, Nl), rand(N, 4)
        b4 = []
        if streams:
            # the widest block a streamed commit absorbs
            b = min(COL_BLOCK, max(Cw, C2, 2 * Q))
            states, block = rand(N, 12), rand(b, N)
            st_k, st_p = states.clone(), states.clone()  # absorbed in place
            b4 = [
                ("poseidon2_permute",
                 lambda: p2.poseidon2_permutation(states),
                 lambda: p2.permutation_plain(states),
                 w * 24 * N, f"({N}, 12) states"),
                ("poseidon2_absorb",
                 lambda: p2.absorb_cols(st_k, block),
                 lambda: p2.absorb_cols_plain(st_p, block),
                 w * (24 * N + b * N), f"({b}, {N}) block into ({N}, 12) states"),
            ]
        # the quotient's one row of Q·n words, interpolated (prover.py)
        log_q = log_n + Q.bit_length() - 1
        quot = rand(1, 1 << log_q)
        return b4 + [
            ("ntt_forward",
             own_ops(lambda: ntt.fft_natural_to_bitreversed(setup_m, scale_row),
                     ntt_kernel_ops(log_n, Cs, scaled=True)),
             lambda: ntt.fft_plain(setup_m, scale_row),
             w * (2 * Cs * n + n + n // 2), f"({Cs}, 2^{log_n}) x coset row of {Q}"),
            ("ntt_inverse",
             own_ops(lambda: ntt.ifft_bitreversed_to_natural(wit),
                     ntt_kernel_ops(log_n, Cw, inverse=True)),
             lambda: ntt.ifft_plain(wit),
             w * (2 * Cw * n + n // 2), f"({Cw}, 2^{log_n})"),
            ("ntt_inverse",
             own_ops(lambda: ntt.ifft_bitreversed_to_natural(quot),
                     ntt_kernel_ops(log_q, 1, inverse=True)),
             lambda: ntt.ifft_plain(quot),
             w * (2 * (1 << log_q) + (1 << log_q) // 2), f"(1, 2^{log_q}) quotient row"),
            ("ntt_lde",
             own_ops(lambda: ntt.lde_from_monomial(wit, L),
                     ntt_kernel_ops(log_n, Cw * L, scaled=True)),
             lambda: ntt.lde_plain(wit, ntt.lde_scale_rows(log_n, L, dev)),
             w * (Cw * n + L * n + n // 2 + Cw * L * n), f"({Cw}, 2^{log_n}) -> x{L}"),
            ("poseidon2_leaf",
             lambda: p2.leaf_hash(leaves),
             lambda: p2.leaf_hash_plain(leaves),
             w * (Cl * Nl + 4 * Nl), f"({Cl}, 2^{Nl.bit_length() - 1}) leaves"),
            ("poseidon2_node",
             lambda: p2.node_hash(layer),
             lambda: p2.node_hash_plain(layer),
             w * (4 * N + 2 * N), f"({N}, 4) -> ({N // 2}, 4)"),
            sweep_row,
        ] + fold_cases(n, N, cfg.fri_final_degree)

    def sweep_case(asm, log_n):
        """(plan, operands, the quotient_sweep row) of one coset of the
        prove of `asm`'s circuit at 2^log_n rows, on random words."""
        n = 1 << log_n
        _tree, sel_paths = build_selector_tree(asm.gates)
        lp = asm.lookup_params if asm.lookups_enabled else None
        Ct = asm.num_copy_cols_total
        plan = qs.SweepPlan(asm.gates, sel_paths, asm.geometry, Ct, dev, lp)
        Cw, Cs, C2 = plan.num_wit_rows, plan.num_setup_cols, plan.num_s2_rows
        table = qs.sweep_table(plan, (3, 5), (7, 11), (13, 17),
                               [int(v) for v in range(1, Ct + 1)], dev,
                               (19, 23), (29, 31))
        args = (rand(Cw, n), rand(Cs, n), rand(C2, n), rand(2, n), rand(n), rand(n), rand(n))
        return plan, args, (
            "quotient_sweep",
            own_ops(lambda: torch.stack(qs.coset_terms(plan, *args, table)),
                    n * sweep_kernel_ops(plan, True)),
            lambda: torch.stack(qs.coset_terms_plain(plan, *args, table)),
            w * ((Cw + Cs + C2 + 2 + 3) * n + table.numel() + 2 * n),
            f"one coset of 2^{log_n} rows: {Cw} witness, {Cs} setup, {C2} stage-2 rows, "
            f"{plan.num_slots} slots")

    def entry_cases():
        """(entry, path, kernel call, plain call, bytes moved, shape) of each
        standalone entry of the sweep at the shapes of the path whose part
        it computes: the gate terms with witness loads, the copy
        permutation and the general lookup terms at 2^20 rows, the
        specialized lookup terms at the sha256 2^16 widths."""
        wit_asm = next(asm for p, asm, _l, _c in paths if p == WIT_PATH)
        _tree, wit_paths = build_selector_tree(wit_asm.gates)
        gate_fn = qs.gate_terms_fn(wit_asm.gates, wit_paths, wit_asm.geometry, dev)
        n, ns, nh = 1 << LOG_N, 1 << SHA_LOG_N, 1 << HASH_LOG_N
        pows = lambda k: [(3 + i, 5 + i) for i in range(k)]  # noqa: E731
        lk = lambda r, wd: ((19, 23), (29, 31), pows(r + 1), r, wd)  # noqa: E731
        cases = [
            ("gate_terms_fn", WIT_PATH, gate_fn.launch,
             (rand(8, n), rand(4, n), rand(6, n),
              pows(qs.num_gate_terms(wit_asm.gates, wit_asm.geometry))),
             f"2^{LOG_N} rows: 8 copy, 4 witness, 6 constant columns",
             gate_rows_read(wit_asm.gates, wit_paths, wit_asm.geometry, 8)),
            ("cp_quotient", GEN_PATH, qs.cp_quotient_launch,
             (rand(4, n), rand(2, n), rand(8, n), rand(8, n), rand(n), rand(n), (3, 5),
              (7, 11), pows(3), list(range(1, 9)), 4),
             f"2^{LOG_N} rows: 8 copy columns in 2 chunks"),
            ("lookup_quotient_general", GEN_PATH, qs.lookup_quotient_general_launch,
             (rand(6, n), rand(6, n), rand(n), rand(4, n), rand(n), rand(n), *lk(2, 3)),
             f"2^{LOG_N} rows: 2 sub-arguments of width 3"),
            ("lookup_quotient", SHA_PATH, qs.lookup_quotient_launch,
             (rand(18, ns), rand(32, ns), rand(ns), rand(5, ns), rand(ns), *lk(8, 4)),
             f"2^{SHA_LOG_N} rows: 8 sub-arguments of width 4"),
        ]
        # the programs the renumbered slots let the kernel take: the byte
        # tri-add (43 values, blake2s), the u32 fma (33) and a 12×12 matrix
        # (480), each alone over sha256's columns (no selector)
        matrix = [[int(v) for v in row] for row in np.random.default_rng(12).integers(
            0, gf.P, (12, 12), dtype=np.uint64)]
        # and the two flattened permutation gates, each alone over 2^18 rows
        # of the recursion geometry's 130 copy and 8 constant columns (their
        # programs read from global memory)
        for gate, path, geom in (
                (ByteTriAddGate.instance(), BLAKE_PATH, SHA256_GEOMETRY),
                (U32FmaGate.instance(), GATES_PATH, SHA256_GEOMETRY),
                (MatrixMultiplicationGate("mds12", matrix), GATES_PATH, SHA256_GEOMETRY),
                (Poseidon2FlattenedGate.instance(), REC_GATES_PATH, RECURSION_GEOMETRY),
                (PoseidonFlattenedGate.instance(), REC_GATES_PATH, RECURSION_GEOMETRY)):
            fn = qs.gate_terms_fn([gate], [[]], geom, dev)
            reps = gate.num_repetitions(geom)
            cg = geom.num_columns_under_copy_permutation
            slots = qs.encode_gate_programs([gate], [[]], geom, cg)[2]
            cases.append(("gate_terms_fn", path, fn.launch,
                          (rand(cg, nh), None, rand(8, nh), pows(reps * gate.num_terms)),
                          f"2^{HASH_LOG_N} rows: {gate.name} x{reps}, {slots} slots",
                          gate_rows_read([gate], [[]], geom, cg)))
        out = []
        for entry, path, launch, a, shape, *rows_read in cases:
            plan, ops, table = launch(*a)
            # the gate terms read only the columns their programs load
            read = (rows_read[0] * ops.n if rows_read
                    else sum(t.numel() for t in ops.tensors() if t is not None))
            nbytes = w * (read + table.numel() + 2 * ops.n)
            out.append((entry, path,
                        own_ops(lambda b=(plan, ops, table): torch.stack(qs.sweep(*b)),
                                ops.n * sweep_kernel_ops(plan, False)),
                        lambda b=(plan, ops, table): torch.stack(qs.sweep_plain(*b)),
                        nbytes, shape))
        return out

    def size_cases():
        """(name, kernel call, plain call, bytes moved, shape) of the NTT at
        sizes beyond the proves' (two or three passes): B1 on 4 rows with a
        coset row, B2 on 4 rows, B3 on 2 rows into 8 cosets."""
        for log_n in NTT_SIZES:
            n = 1 << log_n
            x, scale = rand(4, n), ntt.lde_scale_rows(log_n, 8, dev)
            yield ("ntt_forward",
                   own_ops(lambda x=x, row=scale[5]: ntt.fft_natural_to_bitreversed(x, row),
                           ntt_kernel_ops(log_n, 4, scaled=True)),
                   lambda x=x, row=scale[5]: ntt.fft_plain(x, row),
                   w * (2 * 4 * n + n + n // 2), f"(4, 2^{log_n}) x coset row of 8")
            yield ("ntt_inverse",
                   own_ops(lambda x=x: ntt.ifft_bitreversed_to_natural(x),
                           ntt_kernel_ops(log_n, 4, inverse=True)),
                   lambda x=x: ntt.ifft_plain(x),
                   w * (2 * 4 * n + n // 2), f"(4, 2^{log_n})")
            yield ("ntt_lde",
                   own_ops(lambda x=x[:2]: ntt.lde_from_monomial(x, 8),
                           ntt_kernel_ops(log_n, 16, scaled=True)),
                   lambda x=x[:2], sc=scale: ntt.lde_plain(x, sc),
                   w * (2 * n + 8 * n + n // 2 + 16 * n), f"(2, 2^{log_n}) -> x8")

    cases = [(name, None, path, kern, plain, nbytes, shape, None)
             for path, asm, log_n, cfg in paths
             for name, kern, plain, nbytes, shape in path_cases(asm, log_n, cfg)]
    cases += [(name, None, path, kern, plain, nbytes, shape, None)
              for path, asm, log_n in sweep_paths
              for name, kern, plain, nbytes, shape in [sweep_case(asm, log_n)[2]]]
    cases += [(name, None, SIZES_PATH, kern, plain, nbytes, shape, None)
              for name, kern, plain, nbytes, shape in size_cases()]
    cases += [("quotient_sweep", entry, path, kern, plain, nbytes, shape, None)
              for entry, path, kern, plain, nbytes, shape in entry_cases()]
    # B7 at phase 18's schedule: its entries of 5 and 4 rounds split into
    # two launches, the second reading the first table at a stride
    cases += [(name, None, SPLIT_PATH, kern, plain, nbytes, shape, None)
              for name, kern, plain, nbytes, shape in fold_cases(
                  1 << SHA_LOG_N, 8 << SHA_LOG_N, 16, SPLIT_SCHEDULE)]
    cases += [(name, None, path, kern, plain, nbytes, shape, int_ops)
              for path, asm, log_n, cfg in bb_paths
              for name, kern, plain, nbytes, shape, int_ops in bb_cases(asm, log_n,
                                                                         cfg.fri_lde_factor)]
    rows = []
    for name, entry, path, kern, plain, nbytes, shape, int_ops in cases:
        t0 = time.perf_counter()
        before = K.LAUNCHES[name]
        got = kern()
        per_call = K.LAUNCHES[name] - before
        # B4 and B5 price the internal layer's power-of-two products as shifts
        with FieldOpCounter(gf, shifts=name in GL_POSEIDON2) as ops:
            want = plain()
        if isinstance(got, tuple):  # the fold's two components
            got, want = torch.stack(got), torch.stack(want)
        torch.cuda.synchronize()
        err = max_abs_err(gf, got, want)
        del got, want
        # up to 50 launches for a short kernel, whose wrapper's host work
        # otherwise makes a few launches' mean noisy
        reps = max(5, min(50, int(20 / max(timed(torch, kern, 1), 0.01))))
        ms = timed(torch, kern, reps, warm_up=False)
        plain_ms = timed(torch, plain, 1, warm_up=False)  # warmed by the comparison
        bound_bytes = nbytes / MEM_BYTES_PER_S * 1e3
        # B8 counts its own operations: the plain version's are not the field
        # primitives FieldOpCounter wraps
        plain_ops = ops.pipe_ops() if int_ops is None else int_ops
        # where the kernel does the same function in fewer instructions than
        # the plain version's count (the NTT, B6), that count is no lower
        # bound: the bound takes the lesser of the two
        own = getattr(kern, "own_ops", None)
        bound_ops = min(plain_ops, own if own is not None else plain_ops) / int_ops_per_s * 1e3
        lib, replaces = K.KERNELS[name]
        row = {
            "name": name,
            "entry": entry,
            "route": "cuda",
            "source": f"boojum_tpu_torch/csrc/{lib}.cu",
            "replaces": K.SWEEP_ENTRIES[entry] if entry else replaces,
            "path": path,
            "shape": shape,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": None,
            "launches_per_call": per_call,
        }
        if int_ops is None:
            row["bound_canonical_ms"] = max(
                bound_bytes, ops.pipe_ops(canonical=True) / int_ops_per_s * 1e3)
        if own is not None:  # the plain count's and the kernel's own bounds
            row["bound_plain_ms"] = max(bound_bytes, plain_ops / int_ops_per_s * 1e3)
            row["bound_own_ms"] = max(bound_bytes, own / int_ops_per_s * 1e3)
        rounds = getattr(kern, "rounds_bound", None)
        if rounds is not None:  # B7: the same rounds one at a time, each with its table
            row["bound_rounds_ms"] = max(rounds[1] / MEM_BYTES_PER_S * 1e3,
                                         rounds[0] / int_ops_per_s * 1e3)
        rows.append(row)
        extra = "".join(f" {k[6:-3]} {row[k]:.3f}" for k in (
            "bound_canonical_ms", "bound_plain_ms", "bound_rounds_ms", "bound_own_ms")
            if k in row)
        log(f"  {entry or name:23s} {shape:40s} err={err} kernel {ms:.3f} ms  plain "
            f"{plain_ms:.1f} ms  bound {row['bound_ms']:.3f} ms "
            f"({row['bound_by']}{extra})  launches {per_call}  "
            f"[{time.perf_counter() - t0:.1f} s]")
        if err:
            raise AssertionError(f"kernel {name} ({path}) disagrees with its plain version")
        want_launches = getattr(kern, "schedule_launches", None)
        if want_launches is not None and per_call != want_launches:
            raise AssertionError(f"kernel {name} ({path}, {shape}): {per_call} launches "
                                 f"a call, not the schedule's {want_launches}")
    return rows


def check_proof(label, asm, setup, proof) -> None:
    """The port's check of a proof: the verifier for a Goldilocks proof; for
    a BabyBear one (which has no verifier in the JAX package either) the
    quotient identity at z from the proof's openings, the proof of work and
    every query's Merkle paths against their caps."""
    from boojum_tpu_torch.prover import verify
    from boojum_tpu_torch.prover.prover_bb import query_paths_hold, quotient_identity_at_z

    if asm.field == "babybear":
        if not quotient_identity_at_z(asm, setup, proof):
            raise AssertionError(f"{label}: the quotient identity at z fails")
        if not query_paths_hold(asm, setup, proof):
            raise AssertionError(f"{label}: a query's Merkle path or the proof of work fails")
    elif not verify(setup.vk, proof, asm.gates):
        raise AssertionError(f"{label}: proof rejected by the verifier")


# Phase 4's Goldilocks circuits: (label, circuit, transcript kind). Each is
# set up and proved on the CPU, the slowest part of the run (all CPU), by
# child processes started before phase 3, which print the setup cap and
# the proof JSON of each as a line; CPU_PROOF builds the circuits (their
# proof configs under the transcript named).
PHASE4_PAIRS = (
    ("fma 2^10", "fma", "poseidon2"),
    *((f"fma 2^10, {kind} transcript", "fma", kind) for kind in TRANSCRIPT_KINDS),
    ("xor4 lookup 2^9", "xor4", "poseidon2"),
    ("general lookups 2^9", "general", "poseidon2"),
    ("witness columns 2^5", "witness", "poseidon2"),
    ("gate zoo 2^9", "gate zoo", "poseidon2"),
)
# the 130-column circuits, in the sha256 "abc" child after that circuit,
# collected after phase 8
PHASE4_WIDE_PAIRS = (
    ("poseidon2 flat chain, 16 rows", "poseidon2 chain", "poseidon2"),
    ("legacy poseidon flat chain, 16 rows", "poseidon chain", "poseidon2"),
    ("queue round trip 2^12", "queue", "poseidon2"),
    ("recursion over a fibonacci proof, 2^10", "recursion", "poseidon2"),
    ("recursion over a poseidon-transcript fibonacci proof, 2^10", "recursion poseidon",
     "poseidon2"),
)
CPU_PROOF = """
import dataclasses, json, os, sys
import torch
# below the parent's phase 3, whose short launches wait on the host
os.nice(10)
torch.set_num_threads(int(sys.argv[2]))
sys.path.insert(0, sys.argv[1])
from boojum_tpu_torch import circuits
from boojum_tpu_torch.prover import generate_setup, prove
CIRCUITS = {
    "fma": (lambda: circuits.build_fma(10), circuits.fma_proof_config),
    "xor4": (lambda: circuits.build_xor_lookup()[0], circuits.xor_lookup_proof_config),
    "general": (lambda: circuits.build_general_lookup()[0], circuits.small_proof_config),
    "witness": (lambda: circuits.build_zero_check_witness()[0], circuits.small_proof_config),
    "gate zoo": (lambda: circuits.build_gate_zoo(9)[0], circuits.gate_zoo_proof_config),
    "sha256 abc": (lambda: circuits.build_sha256(message=b"abc")[0],
                   circuits.sha256_proof_config),
    "poseidon2 chain": (lambda: circuits.build_permutation_chain()[0],
                        circuits.hash_gate_proof_config),
    "poseidon chain": (lambda: circuits.build_permutation_chain(legacy=True)[0],
                       circuits.hash_gate_proof_config),
    "queue": (lambda: circuits.build_queue_roundtrip()[0],
              circuits.recursion_small_proof_config),
    "recursion": (lambda: circuits.build_fibonacci_recursion("poseidon2", "cpu")[0],
                  circuits.recursion_small_proof_config),
    "recursion poseidon": (lambda: circuits.build_fibonacci_recursion("poseidon", "cpu")[0],
                           circuits.recursion_small_proof_config),
}
for name, kind in zip(sys.argv[3::2], sys.argv[4::2]):
    build, config = CIRCUITS[name]
    asm = build().into_assembly()
    cfg = dataclasses.replace(config(), transcript=kind)
    setup = generate_setup(asm, cfg, device="cpu")
    proof = prove(asm, setup, cfg, device="cpu")
    print(json.dumps({"cap": [list(c) for c in setup.vk.setup_merkle_cap],
                      "proof": proof.to_json()}), flush=True)
"""
# Phase 19's synthesis: a child process started right after phase 7 reads
# that proof's VK and proof JSON, synthesizes the recursion circuit over it
# and pickles the assembly, the inner public inputs and its own seconds.
RECURSION_SYNTHESIS = """
import os, pickle, sys, time
os.nice(10)
sys.path.insert(0, sys.argv[1])
from boojum_tpu_torch.circuits import build_recursion
from boojum_tpu_torch.compat import port_gate
from boojum_tpu_torch.prover.proof import Proof
from boojum_tpu_torch.serialization import vk_from_json
vk_path, proof_path, out = sys.argv[2:5]
vk = vk_from_json(open(vk_path).read())
proof = Proof.from_json(open(proof_path).read())
t = time.perf_counter()
cs = build_recursion(vk, [proof], [port_gate(name) for name in vk.gate_names])
asm = cs.into_assembly()
secs = time.perf_counter() - t
print(f"recursion over one sha256 proof: synthesis {secs:.1f} s, resolver "
      f"{cs.resolver.name}", flush=True)
with open(out, "wb") as f:
    pickle.dump({"asm": asm, "synthesis_s": secs, "output": proof.public_inputs,
                 "resolver": cs.resolver.name}, f, protocol=pickle.HIGHEST_PROTOCOL)
"""
# The 2^20 and 2^18 paths' synthesis (pure Python, 20 s to a minute each):
# a child process started before phase 3 (phases 15-17) or after it
# (phases 5, 9, 10, 12, 13) synthesizes the circuit at 2^log_n rows and pickles
# its assembly, its output (a hash's digest bytes; the ladder's affine
# result, identity flag and scalar; a public input's value) and its own
# seconds to a file.
CPU_SYNTHESIS = """
import os, pickle, sys, time
os.nice(10)
sys.path.insert(0, sys.argv[1])
from boojum_tpu_torch import circuits, gadgets
which, log_n, out = sys.argv[2], int(sys.argv[3]), sys.argv[4]
t = time.perf_counter()
if which in ("fma", "fma_babybear"):
    cs = circuits.build_fma(log_n, field="babybear" if which == "fma_babybear" else "goldilocks")
elif which == "xor_lookup_babybear":
    # two lookup rows a step over R = 2 columns
    cs, result, _last = circuits.build_xor_lookup((1 << log_n) - 8, 1 << log_n,
                                                   field="babybear")
else:
    cs, result = getattr(circuits, "build_" + which)(log_n)
asm = cs.into_assembly()
secs = time.perf_counter() - t
print(f"{which} 2^{log_n}: synthesis {secs:.1f} s, resolver {cs.resolver.name}", flush=True)
if which == "secp256k1_ladder":
    output = {"affine": (result.x.get_value(cs), result.y.get_value(cs)),
              "at_infinity": result.at_infinity.get_value(cs), "scalar": result.scalar}
elif which in ("keccak256", "blake2s"):
    output = getattr(gadgets, which + "_digest_bytes")(cs, result)
elif which in ("fma", "fma_babybear"):
    output = None
else:
    output = cs.get_value(result)
with open(out, "wb") as f:
    pickle.dump({"asm": asm, "synthesis_s": secs, "output": output,
                 "resolver": cs.resolver.name}, f, protocol=pickle.HIGHEST_PROTOCOL)
"""
# Phase 20's synthesis: a child process started before phase 3 synthesizes
# the sha256 circuit under SETUP_CS_CONFIG (placement, no witness), then
# sha256 over further messages of the same length drawn from a seed
# through the default resolver (the native tape), and pickles the setup
# assembly and, for each message, the witness vector, the places of the 32
# digest variables, the message and its synthesis seconds.
WITNESS_SYNTHESIS = """
import os, pickle, sys, time
import numpy as np
os.nice(10)
sys.path.insert(0, sys.argv[1])
from boojum_tpu_torch.circuits import build_sha256
from boojum_tpu_torch.cs.types import SETUP_CS_CONFIG
nbytes, count, seed, out = int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
t = time.perf_counter()
cs, digest = build_sha256(nbytes, config=SETUP_CS_CONFIG)
setup_asm = cs.into_assembly()
res = {"setup_asm": setup_asm, "setup_synthesis_s": time.perf_counter() - t,
       "setup_digest_places": list(digest), "setup_resolver": cs.resolver.name,
       "witnesses": []}
rng = np.random.default_rng(seed)
for _ in range(count):
    message = rng.bytes(nbytes)
    t = time.perf_counter()
    cs, digest = build_sha256(message=message)
    witness = cs.into_assembly().witness_vec()
    secs = time.perf_counter() - t
    print(f"sha256 {nbytes} B witness: synthesis {secs:.1f} s, resolver {cs.resolver.name}",
          flush=True)
    res["witnesses"].append({"message": message, "witness": witness,
                             "digest_places": list(digest), "synthesis_s": secs,
                             "resolver": cs.resolver.name})
with open(out, "wb") as f:
    pickle.dump(res, f, protocol=pickle.HIGHEST_PROTOCOL)
"""
CHILDREN: list = []  # stopped when the script ends
TEMP_DIRS: list = []  # removed when the script ends


def start_cpu_child(code: str, *args: str) -> subprocess.Popen:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, str(Path(__file__).resolve().parent), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    CHILDREN.append(proc)
    return proc


def synthesis_child_result(label: str, proc: subprocess.Popen, path: str) -> dict:
    """The assembly, output and synthesis seconds a synthesis child
    pickled, once it ends; the file is removed."""
    import pickle

    out, err = proc.communicate(timeout=1100)
    if proc.returncode != 0:
        raise AssertionError(f"{label}: the synthesis child failed (rc {proc.returncode}):\n"
                             f"{err[-4000:]}")
    for line in out.strip().splitlines():
        log(f"    child: {line}")
    with open(path, "rb") as f:
        res = pickle.load(f)
    os.remove(path)
    return res


def cpu_child_lines(label: str, proc: subprocess.Popen, count: int) -> list:
    """The first `count` (setup cap, proof JSON) lines a CPU child prints, as
    they come, while it goes on with the rest."""
    out = []
    for _ in range(count):
        line = proc.stdout.readline()
        if not line:
            raise AssertionError(f"{label}: the CPU child stopped (rc {proc.wait()}):\n"
                                 f"{proc.stderr.read()[-4000:]}")
        r = json.loads(line)
        out.append((r["cap"], r["proof"]))
    return out


def cpu_child_results(label: str, proc: subprocess.Popen) -> list:
    """[(setup cap, proof JSON)] printed by a CPU child, once it ends, one
    for each circuit it was given (past those read by cpu_child_lines)."""
    out, err = proc.communicate(timeout=1100)
    if proc.returncode != 0:
        raise AssertionError(f"{label}: the CPU child failed (rc {proc.returncode}):\n"
                             f"{err[-4000:]}")
    return [(r["cap"], r["proof"]) for r in map(json.loads, out.strip().splitlines())]


def card_against_cpu(torch, label, asm, cfg, cpu_side=None) -> float:
    """Set up and prove `asm` on the card and on the CPU: the same setup cap
    and the same proof JSON text, accepted by the check. With `cpu_side`,
    the CPU side is the (cap, proof JSON) it returns: a child process's."""
    from boojum_tpu_torch.prover import generate_setup, prove

    t = time.perf_counter()
    s_gpu = generate_setup(asm, cfg, device="cuda")
    p_gpu = prove(asm, s_gpu, cfg, device="cuda")
    if cpu_side is None:
        s_cpu = generate_setup(asm, cfg, device="cpu")
        cap_cpu = s_cpu.vk.setup_merkle_cap
    else:
        cap_cpu, proof_cpu = cpu_side()
    if [list(c) for c in s_gpu.vk.setup_merkle_cap] != [list(c) for c in cap_cpu]:
        raise AssertionError(f"{label}: setup caps differ between the card and the CPU")
    if cpu_side is None:
        proof_cpu = prove(asm, s_cpu, cfg, device="cpu").to_json()
    if p_gpu.to_json() != proof_cpu:
        raise AssertionError(f"{label}: proofs differ between the card and the CPU")
    check_proof(label, asm, s_gpu, p_gpu)
    secs = time.perf_counter() - t
    log(f"[4] {label}: card and CPU setups and proofs identical ({len(p_gpu.to_json())} "
        f"bytes), verified ({secs:.1f} s{', CPU side in a child process' if cpu_side else ''})")
    return secs


def drive_path(torch, label, synthesize, cfg, log_n, phase, streams) -> dict:
    """One path through the entry points a user calls, with the launch
    counts set to 0 just before synthesis and read after verification.
    synthesize() returns (assembly, a check of the circuit's output that
    takes the proof), and a third item, the synthesis seconds, where a
    child process synthesized it; the assembly must have 2^log_n rows, the size phase 3
    checked the kernels at. `streams` says whether the prover's rule must
    stream this path's commits: the absorb kernel then launches on the
    prove, and otherwise never on the path. A BabyBear path launches B8 and
    no Goldilocks kernel; a Goldilocks path no B8, and the fold once per
    committed FRI oracle."""
    from boojum_tpu_torch import kernels as K
    from boojum_tpu_torch.prover import fri, generate_setup, prove

    K.reset_launches()
    t = time.perf_counter()
    asm, check_output, *child = synthesize()
    synth_s = child[0] if child else time.perf_counter() - t
    resolver = child[1] if child else asm.resolver.name
    log(f"[{phase}] {label}: synthesis {synth_s:.1f} s"
        f"{' in a child process' if child else ''} (resolver {resolver}), "
        f"{asm.trace_len} rows")
    if asm.trace_len != 1 << log_n:
        raise AssertionError(f"{label}: {asm.trace_len} rows, not 2^{log_n}")
    t = time.perf_counter()
    setup = generate_setup(asm, cfg, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    at_setup = dict(K.LAUNCHES)
    log(f"[{phase}] setup {setup_s:.1f} s; launches {at_setup}")
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    t = time.perf_counter()
    proof = prove(asm, setup, cfg, device="cuda", timings=timings)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**30
    on_prove = {k: v - at_setup[k] for k, v in K.LAUNCHES.items()}
    log(f"[{phase}] prove {prove_s:.2f} s, peak device memory {peak:.2f} GiB; rounds "
        + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
        + f"; launches {on_prove}")
    t = time.perf_counter()
    check_proof(label, asm, setup, proof)
    if len(proof.queries) != cfg.num_queries or not proof.fri_caps:
        raise AssertionError(f"{label}: proof has the wrong shape")
    check_output(proof)
    verify_s = time.perf_counter() - t
    launches = dict(K.LAUNCHES)
    log(f"[{phase}] verified, output checked ({verify_s:.1f} s); launches on the "
        f"path {launches}")
    # the bare permutations of B4 and B8 are on no prove: the absorb and
    # the leaf and node kernels carry them there
    b8 = {k for k in K.KERNELS if k.startswith("poseidon2_bb")}
    if asm.field == "babybear":
        expected = ["poseidon2_bb_leaf", "poseidon2_bb_node"]
        foreign = [k for k in K.KERNELS if k not in b8 and launches[k]]
    else:
        expected = [k for k in K.KERNELS if k not in b8 and k != "poseidon2_permute"
                    and (streams or k != "poseidon2_absorb")]
        foreign = [k for k in b8 if launches[k]]
    missing = [k for k in expected if launches[k] == 0 or on_prove[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched on the prove: {missing}")
    if foreign:
        raise AssertionError(f"{label}: the other field's kernels launched: {foreign}")
    if not streams and launches["poseidon2_absorb"]:
        raise AssertionError(f"{label}: the commits streamed below the threshold")
    if asm.field != "babybear":  # B7: one launch per committed oracle
        schedule = fri.fold_schedule(asm.trace_len, cfg.fri_final_degree,
                                     cfg.fri_folding_schedule)
        folds = sum(-(-k // fri.MAX_FOLD_K) for k in schedule)
        if on_prove["fri_fold"] != folds:
            raise AssertionError(f"{label}: {on_prove['fri_fold']} fold launches on the "
                                 f"prove, not {folds} for the schedule {schedule}")
        # B6: one launch per quotient coset
        if on_prove["quotient_sweep"] != setup.vk.quotient_degree:
            raise AssertionError(f"{label}: {on_prove['quotient_sweep']} sweep launches on "
                                 f"the prove, not one per coset of {setup.vk.quotient_degree}")
    return dict(asm=asm, setup=setup, proof=proof, launches=launches,
                launches_on_prove=on_prove, resolver=resolver,
                synthesis_s=synth_s, setup_s=setup_s, prove_cold_s=prove_s,
                rounds_cold_s=timings, verify_s=verify_s, peak_device_memory_gib=peak)


def drive_rewitness(torch, label, res, cfg, inner_vk, inner_proof, log_n) -> dict:
    """Phase 20: Era's prover, one setup and a proof for each new witness.
    `res` is the witness child's: the setup-only assembly of the sha256
    circuit and, for each further message, its witness vector. The launch
    counts go to 0 before the setup and are read after the last proof's
    check. The setup's VK must be phase 7's (`inner_vk`); each witness is
    taken over by `with_external_witness`, proved on the card, verified
    under that VK, its digest read from its witness vector at the digest
    places must be hashlib's, and every witness cap (phase 7's too) must
    differ. The last proof is profiled as phase 6."""
    from boojum_tpu_torch import kernels as K
    from boojum_tpu_torch.prover import fri, generate_setup, prove, verify
    from boojum_tpu_torch.serialization import vk_to_json

    K.reset_launches()
    asm = res["setup_asm"]
    if asm.trace_len != 1 << log_n or asm.copy_cols_values.any():
        raise AssertionError(f"{label}: the setup-only assembly is not 2^{log_n} rows of "
                             f"placement without values")
    t = time.perf_counter()
    setup = generate_setup(asm, cfg, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    if vk_to_json(setup.vk) != vk_to_json(inner_vk):
        raise AssertionError(f"{label}: the setup-only VK differs from phase 7's")
    log(f"[20] {label}: setup-only synthesis {res['setup_synthesis_s']:.1f} s in a child "
        f"process (resolver {res['setup_resolver']}); setup {setup_s:.1f} s, VK equal to "
        f"phase 7's")
    caps = [inner_proof.witness_cap]
    out = {"setup_synthesis_s": res["setup_synthesis_s"], "setup_s": setup_s, "proofs": []}
    for i, item in enumerate(res["witnesses"]):
        if item["digest_places"] != res["setup_digest_places"]:
            raise AssertionError(f"{label}: witness {i} places its digest elsewhere")
        wv = item["witness"]
        digest = bytes(int(wv[place]) for place in item["digest_places"])
        if digest != hashlib.sha256(item["message"]).digest():
            raise AssertionError(f"{label}: witness {i}'s digest differs from hashlib's")
        t = time.perf_counter()
        wasm = asm.with_external_witness(wv)
        take_s = time.perf_counter() - t
        t = time.perf_counter()
        proof = prove(wasm, setup, cfg, device="cuda")
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t
        if not verify(inner_vk, proof, wasm.gates):
            raise AssertionError(f"{label}: witness {i}'s proof rejected under phase 7's VK")
        caps.append(proof.witness_cap)
        log(f"[20] witness {i} (synthesis {item['synthesis_s']:.1f} s in the child, "
            f"resolver {item['resolver']}): taken over in {take_s:.2f} s, proved in "
            f"{prove_s:.2f} s, verified under phase 7's VK, digest = hashlib's")
        out["proofs"].append({"synthesis_s": item["synthesis_s"], "resolver": item["resolver"],
                              "with_external_witness_s": take_s, "prove_s": prove_s})
    if len({json.dumps(c) for c in caps}) != len(caps):
        raise AssertionError(f"{label}: two witness caps are equal")
    launches = dict(K.LAUNCHES)
    expected = [k for k in K.KERNELS if not k.startswith("poseidon2_bb")
                and k not in ("poseidon2_permute", "poseidon2_absorb")]
    missing = [k for k in expected if launches[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched: {missing}")
    schedule = fri.fold_schedule(asm.trace_len, cfg.fri_final_degree, cfg.fri_folding_schedule)
    proofs = len(res["witnesses"])
    folds = proofs * sum(-(-k // fri.MAX_FOLD_K) for k in schedule)
    if launches["fri_fold"] != folds or launches["quotient_sweep"] != (
            proofs * setup.vk.quotient_degree):
        raise AssertionError(f"{label}: {launches['fri_fold']} fold and "
                             f"{launches['quotient_sweep']} sweep launches for {proofs} proofs")
    log(f"[20] {proofs} witnesses proved against one setup, witness caps all differ; "
        f"launches on the path {launches}")
    out["launches"] = launches
    out["profile"] = profile_prove(torch, prove, wasm, setup, cfg)
    return out


def drive_mini_stark(torch, label, log_n, phase) -> dict:
    """Phase 14: the BabyBear mini-STARK proved on the card with the launch
    counts set to 0 just before and read after its verifier, which must
    accept; B8's leaf and node kernels must have launched."""
    from boojum_tpu_torch import kernels as K
    from boojum_tpu_torch.prover.bb_prover import BBProofConfig, prove_babybear
    from boojum_tpu_torch.prover.bb_verifier import check_babybear

    cfg = BBProofConfig(log_n=log_n)
    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    proof = prove_babybear(20260, cfg, device="cuda")
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t
    t = time.perf_counter()
    ok, reason = check_babybear(proof)
    verify_s = time.perf_counter() - t
    launches = dict(K.LAUNCHES)
    if not ok:
        raise AssertionError(f"{label}: rejected by its verifier ({reason})")
    missing = [k for k in ("poseidon2_bb_leaf", "poseidon2_bb_node") if launches[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched on the prove: {missing}")
    t = time.perf_counter()
    prove_babybear(20260, cfg, device="cuda")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{phase}] {label}: prove {cold_s:.3f} s cold, {warm_s:.3f} s warm, peak device "
        f"memory {peak:.2f} GiB, {cfg.num_folds} folds; verified ({verify_s:.1f} s); "
        f"launches {launches}")
    return dict(launches=launches, prove_cold_s=cold_s, prove_warm_s=warm_s,
                verify_s=verify_s, peak_device_memory_gib=peak)


def gate_rows_read(gates, selector_paths, geometry, wit_col: int) -> int:
    """The operand columns (of n words each) that a gate-terms launch reads:
    every column each gate's program loads, at each of its instances, and
    each selector's constant column; a column two gates read counts once."""
    from boojum_tpu_torch.cs.gate_capture import capture_gate_program

    cells = set()
    for gate, path in zip(gates, selector_paths):
        if not gate.num_terms:
            continue
        reps = gate.num_repetitions(geometry)
        cells.update(("consts", i) for i in range(len(path)))
        for _slot, kind, idx in capture_gate_program(gate).loads:
            if kind == "c":  # one constant column for every instance
                cells.add(("consts", len(path) + idx))
            else:
                base, stride = ((0, gate.principal_width) if kind == "v"
                                else (wit_col, gate.witness_width))
                cells.update(("cols", base + r * stride + idx) for r in range(reps))
    return len(cells)


def fma_chain_value(log_n: int, p: int) -> int:
    """The fma chain's public input computed on the host: (a, b) -> (b, a·b + a)
    from (1, 2), four steps a row over 2^log_n - 8 rows."""
    a, b = 1, 2
    for _ in range(((1 << log_n) - 8) * 4):
        a, b = b, (a * b + a) % p
    return b


def stream_modes(torch, label, asm, setup, cfg) -> dict:
    """Phase 11: the default rule, every commit streamed (threshold 0, a
    streamed setup) and none streamed (math.inf), each proved twice (the
    second timed, with its peak device memory); the same proof bytes from
    all three, each verified. Takes over `setup`, the default rule's."""
    from boojum_tpu_torch.prover import generate_setup, prove, verify

    t0 = time.perf_counter()
    out, proofs = {}, {}
    for mode, threshold in (("default", None), ("materialized", math.inf),
                            ("streamed", 0)):
        kw = {} if threshold is None else {"stream_threshold_bytes": threshold}
        if mode == "streamed":
            del setup
            torch.cuda.empty_cache()
            setup = generate_setup(asm, cfg, device="cuda", **kw)
            if setup.setup_lde is not None:
                raise AssertionError(f"{label}: threshold 0 left the setup materialized")
        prove(asm, setup, cfg, device="cuda", **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2**30
        t = time.perf_counter()
        proof = prove(asm, setup, cfg, device="cuda", **kw)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not verify(setup.vk, proof, asm.gates):
            raise AssertionError(f"{label}: the {mode} proof is rejected")
        proofs[mode] = proof.to_json()
        out[mode] = {"prove_warm_s": warm_s, "peak_device_memory_gib": peak,
                     "allocated_before_prove_gib": base}
        log(f"[11] {label}, {mode}: warm prove {warm_s:.3f} s, peak device memory "
            f"{peak:.2f} GiB ({base:.2f} GiB allocated before the prove), verified")
    if len(set(proofs.values())) != 1:
        raise AssertionError(f"{label}: streamed and materialized proofs differ")
    log(f"[11] the three proofs are the same {len(proofs['default'])} bytes "
        f"({time.perf_counter() - t0:.1f} s)")
    return out


def _device_events(prof):
    """(name, device microseconds) of each activity the card ran under
    `prof`: its kernels, copies and sets, read from the tracer's raw events
    (the profiler's own per-op tables take tens of seconds to build for the
    launches of one prove)."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            yield e.name(), e.duration_ns() / 1e3


def profile_prove(torch, prove, asm, setup, cfg) -> dict:
    """Phase 6: a warm prove, then one under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    warm = {}
    t = time.perf_counter()
    prove(asm, setup, cfg, device="cuda", timings=warm)
    warm_s = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        prove(asm, setup, cfg, device="cuda")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    kernels, plain, copies = {}, {}, 0.0
    for key, us in _device_events(prof):
        if us <= 0 or key.startswith(PROFILER_MARKERS):
            continue
        if key.startswith(("Memcpy", "Memset")):
            copies += us / 1e3
            continue
        port = next((v for k, v in PORT_FUNCTIONS.items() if k in key), None)
        bucket, name = (kernels, port) if port else (plain, key[:80])
        bucket[name] = bucket.get(name, 0.0) + us / 1e3
    busy_ms = sum(kernels.values()) + sum(plain.values()) + copies
    return {
        "prove_warm_s": warm_s,
        "rounds_warm_s": warm,
        "profiled_prove_wall_s": wall_s,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / (wall_s * 1e3),
        "port_kernels_ms": dict(sorted(kernels.items(), key=lambda kv: -kv[1])),
        "plain_torch_ms": sum(plain.values()),
        "plain_torch_top_ms": dict(sorted(plain.items(), key=lambda kv: -kv[1])[:12]),
        "copies_ms": copies,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import boojum_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: boojum_tpu_torch not importable: {e}", file=sys.stderr)
        return 2
    from boojum_tpu_torch import kernels as K
    from boojum_tpu_torch import native
    from boojum_tpu_torch.circuits import (
        bench_message, blake2s_message_len, build_blake2s, build_fibonacci_recursion,
        build_fma, build_gate_zoo, build_general_lookup, build_keccak256,
        build_permutation_chain, build_poseidon_rf, build_queue_roundtrip,
        build_secp256k1_ladder, build_sha256, build_xor_lookup, build_zero_check_witness,
        fma_proof_config, gate_zoo_proof_config, hash_gate_proof_config, keccak256_message_len,
        recursion_small_proof_config, secp256k1_mul_host, sha256_proof_config,
        small_proof_config, xor_lookup_proof_config,
    )
    from boojum_tpu_torch.serialization import vk_to_json
    from boojum_tpu_torch.field.spec import BABYBEAR
    from boojum_tpu_torch.gadgets import sha256_digest_bytes
    from boojum_tpu_torch.hashes.keccak_host import keccak256 as host_keccak256
    from boojum_tpu_torch.ntt import ntt
    from boojum_tpu_torch.prover import ProofConfig, prove

    t0 = time.perf_counter()
    card = nvidia_smi("name,power.limit")
    max_sm_mhz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_ops_per_s = sms * INT32_PER_SM_CLOCK * max_sm_mhz * 1e6
    log(f"[1] card: {card}, torch {torch.__version__} (CUDA {torch.version.cuda}); "
        f"{sms} SMs at up to {max_sm_mhz:.0f} MHz: "
        f"{int_ops_per_s / 1e12:.2f}e12 32-bit integer ops/s "
        f"({time.perf_counter() - t0:.1f} s)")

    t = time.perf_counter()
    built = K.build_all()
    log(f"[2] built {', '.join(p.name for p in built.values())} "
        f"({time.perf_counter() - t:.1f} s)")
    # the native witness resolver, built before the children that load it
    native.get_lib()
    log(f"[2] built {native.library_path().name} with {native.CXX} "
        + (f"({native.BUILD_SECONDS:.1f} s)" if native.BUILD_SECONDS
           else "(built before this run)"))

    cores = os.cpu_count() or 2
    sha_abc_child = start_cpu_child(CPU_PROOF, str(max(1, cores - 4)), "sha256 abc",
                                    "poseidon2", *(a for _label, name, kind in PHASE4_WIDE_PAIRS
                                                   for a in (name, kind)))
    phase4_child = start_cpu_child(CPU_PROOF, "2", *(a for _label, name, kind in PHASE4_PAIRS
                                                     for a in (name, kind)))
    synthesis_children = {}
    TEMP_DIRS.append(tempfile.mkdtemp(prefix="chip_smoke_"))

    def start_synthesis(which, log_n):
        out = os.path.join(TEMP_DIRS[-1], f"{which}.pickle")
        synthesis_children[which] = (
            start_cpu_child(CPU_SYNTHESIS, which, str(log_n), out), out)

    for which, log_n in (("keccak256", HASH_LOG_N), ("blake2s", BLAKE_LOG_N),
                         ("secp256k1_ladder", LADDER_LOG_N)):
        start_synthesis(which, log_n)
    witness_file = os.path.join(TEMP_DIRS[-1], "witnesses.pickle")
    witness_child = start_cpu_child(WITNESS_SYNTHESIS, str(SHA_BYTES), str(REWITNESS_COUNT),
                                    str(REWITNESS_SEED), witness_file)
    t = time.perf_counter()
    asm10 = build_fma(10).into_assembly()
    cs_abc, digest_abc = build_sha256(message=b"abc")
    asm_abc = cs_abc.into_assembly()
    asm_gen = build_general_lookup()[0].into_assembly()
    asm_wit = build_zero_check_witness()[0].into_assembly()
    asm_bb_fma = build_fma(10, field="babybear").into_assembly()
    asm_bb_xor = build_xor_lookup(600, 1 << 11, field="babybear")[0].into_assembly()
    # the JAX tests' keccak256 and blake2s: their gates and oracle widths are
    # the 2^18 paths'
    asm_keccak = build_keccak256()[0].into_assembly()
    asm_blake = build_blake2s()[0].into_assembly()
    # the ladder's gates and oracle widths at two steps (2^12 rows)
    asm_ladder = build_secp256k1_ladder()[0].into_assembly()
    # the recursion circuit's gates and oracle widths, over a Fibonacci proof
    # (2^10 rows): phase 19's over the sha256 proof, at 2^15
    asm_rec = build_fibonacci_recursion("poseidon2", "cuda")[0].into_assembly()
    log(f"[3] kernels against their plain versions at the {FMA_PATH}, {SHA_PATH}, "
        f"{GEN_PATH}, {WIT_PATH}, {KECCAK_PATH}, {LADDER_PATH}, {REC_PATH}, "
        f"{BLAKE_PATH} (the sweep), "
        f"{BB_FMA_PATH} and {BB_XOR_PATH} proves' shapes, and B7 at {SPLIT_PATH}")
    rows = kernel_parity(torch, [
        (FMA_PATH, asm10, LOG_N, fma_proof_config()),
        (SHA_PATH, asm_abc, SHA_LOG_N, sha256_proof_config()),
        (GEN_PATH, asm_gen, LOG_N, sha256_proof_config()),
        (WIT_PATH, asm_wit, LOG_N, sha256_proof_config()),
        (KECCAK_PATH, asm_keccak, HASH_LOG_N, sha256_proof_config()),
        (LADDER_PATH, asm_ladder, LADDER_LOG_N, sha256_proof_config()),
        (REC_PATH, asm_rec, REC_LOG_N, sha256_proof_config()),
    ], [(BLAKE_PATH, asm_blake, BLAKE_LOG_N)], [
        (BB_FMA_PATH, asm_bb_fma, LOG_N, fma_proof_config()),
        (BB_XOR_PATH, asm_bb_xor, LOG_N, sha256_proof_config()),
    ], int_ops_per_s)
    log(f"[3] all {len(rows)} rows word-exact ({time.perf_counter() - t:.1f} s)")
    # the 2^20 paths' synthesis, beside phase 4 (after phase 3, whose
    # short launches wait on the host)
    for which in ("fma", "general_lookup", "zero_check_witness", "fma_babybear",
                  "xor_lookup_babybear"):
        start_synthesis(which, LOG_N)
    # the size rows' tables would otherwise stay allocated under the proves'
    # peak memory
    ntt.clear_tables()
    torch.cuda.empty_cache()

    # the Goldilocks circuits, their CPU sides from a child process
    phase4 = {"fma": (asm10, fma_proof_config()),
              "xor4": (build_xor_lookup()[0].into_assembly(), xor_lookup_proof_config()),
              "general": (asm_gen, small_proof_config()),
              "witness": (asm_wit, small_proof_config()),
              "gate zoo": (build_gate_zoo(9)[0].into_assembly(), gate_zoo_proof_config())}
    small = {}
    cpu_sides = cpu_child_results("phase 4", phase4_child)
    for (label, name, kind), cpu_side in zip(PHASE4_PAIRS, cpu_sides, strict=True):
        asm, cfg = phase4[name]
        small[label] = card_against_cpu(torch, label, asm,
                                        dataclasses.replace(cfg, transcript=kind),
                                        lambda cpu_side=cpu_side: cpu_side)
    # the JAX package's tests/test_bb_full_prover.py config, and under the
    # blake2s transcript (blake2s_babybear)
    bb_small_cfg = ProofConfig(fri_lde_factor=2, num_queries=8, fri_final_degree=8)
    for label, asm, cfg in (
            ("babybear fma 2^10", asm_bb_fma, bb_small_cfg),
            ("babybear xor4 2^10", asm_bb_xor, bb_small_cfg),
            ("babybear poseidon rf 2^8", build_poseidon_rf(field="babybear")[0].into_assembly(),
             bb_small_cfg),
            ("babybear fma 2^10, blake2s_babybear transcript", asm_bb_fma,
             dataclasses.replace(bb_small_cfg, transcript="blake2s"))):
        small[label] = card_against_cpu(torch, label, asm, cfg)

    # the 2^20 paths' syntheses end here, before the first timed main path:
    # no prove of phases 5-8 and 20, nor its profile, shares the host with them
    synthesized = {which: synthesis_child_result(label, *synthesis_children.pop(which))
                   for which, label in (("fma", FMA_PATH), ("general_lookup", GEN_PATH),
                                        ("zero_check_witness", WIT_PATH),
                                        ("fma_babybear", BB_FMA_PATH),
                                        ("xor_lookup_babybear", BB_XOR_PATH))}

    # each main path: every count goes to 0 before it and is read after verify
    def fma_circuit():
        res = synthesized.pop("fma")
        return res["asm"], lambda _proof: None, res["synthesis_s"], res["resolver"]

    fma = drive_path(torch, FMA_PATH, fma_circuit, fma_proof_config(), LOG_N, 5, True)
    t = time.perf_counter()
    prof_fma = profile_prove(torch, prove, fma["asm"], fma["setup"], fma_proof_config())
    prof_fma.update(circuit=FMA_PATH, card=card, **{
        k: fma[k] for k in ("prove_cold_s", "rounds_cold_s", "peak_device_memory_gib")})
    log(f"[6] warm prove {prof_fma['prove_warm_s']:.3f} s, device busy "
        f"{prof_fma['device_busy_ms']:.1f} ms, idle share "
        f"{prof_fma['device_idle_share']:.3f} ({time.perf_counter() - t:.1f} s)")
    del fma["asm"], fma["setup"]

    message = bench_message(SHA_BYTES)
    sha_check = None  # the digest check, kept for phase 18

    def sha_circuit():
        nonlocal sha_check
        cs, digest = build_sha256(SHA_BYTES)

        def sha_check(_proof):
            if sha256_digest_bytes(cs, digest) != hashlib.sha256(message).digest():
                raise AssertionError("sha256 circuit digest differs from hashlib's")

        return cs.into_assembly(), sha_check

    sha = drive_path(torch, SHA_PATH, sha_circuit, sha256_proof_config(), SHA_LOG_N, 7,
                     False)
    # phase 19's synthesis from this proof's VK and proof JSON, in a child
    inner_proof = sha.pop("proof")
    rec_files = [os.path.join(TEMP_DIRS[-1], f) for f in ("vk.json", "proof.json",
                                                          "recursion.pickle")]
    for path, text in zip(rec_files, (vk_to_json(sha["setup"].vk), inner_proof.to_json())):
        with open(path, "w") as f:
            f.write(text)
    rec_child = start_cpu_child(RECURSION_SYNTHESIS, *rec_files)
    t = time.perf_counter()
    prof_sha = profile_prove(torch, prove, sha["asm"], sha["setup"], sha256_proof_config())
    prof_sha.update(circuit=SHA_PATH, card=card,
                    card_against_cpu_s=small, **{
                        k: sha[k] for k in ("synthesis_s", "resolver", "setup_s",
                                            "prove_cold_s", "rounds_cold_s", "verify_s",
                                            "peak_device_memory_gib",
                                            "launches_on_prove")})
    log(f"[8] warm prove {prof_sha['prove_warm_s']:.3f} s, device busy "
        f"{prof_sha['device_busy_ms']:.1f} ms, idle share "
        f"{prof_sha['device_idle_share']:.3f} ({time.perf_counter() - t:.1f} s)")
    profiles = [prof_fma, prof_sha]
    paths = {FMA_PATH: fma["launches"], SHA_PATH: sha["launches"]}
    # phase 20: phase 7's circuit set up from a setup-only synthesis, and
    # proved for further witnesses synthesized by the child started before
    # phase 3
    rew = drive_rewitness(torch, REWITNESS_PATH,
                          synthesis_child_result(REWITNESS_PATH, witness_child, witness_file),
                          sha256_proof_config(), sha["setup"].vk, inner_proof, SHA_LOG_N)
    prof = rew.pop("profile")
    prof.update(circuit=REWITNESS_PATH, card=card, **rew)
    log(f"[20] warm prove {prof['prove_warm_s']:.3f} s, device busy "
        f"{prof['device_busy_ms']:.1f} ms, idle share {prof['device_idle_share']:.3f}")
    paths[REWITNESS_PATH] = prof.pop("launches")
    profiles.append(prof)
    # phase 4's sha256 "abc" and 130-column circuits, their CPU sides from
    # the child started before phase 3, which has run beside phases 3-8
    small["sha256 abc 2^14"] = card_against_cpu(
        torch, "sha256 abc 2^14", asm_abc, sha256_proof_config(),
        lambda: cpu_child_lines("sha256 abc 2^14", sha_abc_child, 1)[0])
    if sha256_digest_bytes(cs_abc, digest_abc) != hashlib.sha256(b"abc").digest():
        raise AssertionError("sha256(b'abc') circuit digest is wrong")
    wide = {"poseidon2 chain": (build_permutation_chain()[0], hash_gate_proof_config()),
            "poseidon chain": (build_permutation_chain(legacy=True)[0],
                               hash_gate_proof_config()),
            "queue": (build_queue_roundtrip()[0], recursion_small_proof_config()),
            "recursion": (build_fibonacci_recursion("poseidon2")[0],
                          recursion_small_proof_config()),
            "recursion poseidon": (build_fibonacci_recursion("poseidon")[0],
                                   recursion_small_proof_config())}
    wide_sides = cpu_child_results("phase 4", sha_abc_child)
    for (label, name, kind), cpu_side in zip(PHASE4_WIDE_PAIRS, wide_sides, strict=True):
        cs, cfg = wide[name]
        small[label] = card_against_cpu(torch, label, cs.into_assembly(),
                                        dataclasses.replace(cfg, transcript=kind),
                                        lambda cpu_side=cpu_side: cpu_side)
    del wide
    # phase 18, run here while phase 7's assembly is at hand: set up and
    # proved again under the keccak256 transcript with a schedule whose
    # entries split into launches, and under the blake2s transcript with 16
    # quotient cosets against 8 committed
    del sha["setup"]
    sha_asm = sha.pop("asm")
    for label, options in (
            (SPLIT_PATH, dict(transcript="keccak256", fri_folding_schedule=SPLIT_SCHEDULE)),
            (Q16_PATH, dict(transcript="blake2s", quotient_degree=16))):
        cfg = dataclasses.replace(sha256_proof_config(), **options)
        run = drive_path(torch, label, lambda: (sha_asm, sha_check), cfg, SHA_LOG_N, 18,
                         False)
        vk = run["setup"].vk
        if ((vk.transcript, vk.fri_folding_schedule, vk.quotient_degree)
                != (cfg.transcript, cfg.fri_folding_schedule, cfg.quotient_degree or 8)):
            raise AssertionError(f"{label}: the key does not carry the options")
        log(f"[18] {label}: the key carries the options; sweep launches on the prove "
            f"{run['launches_on_prove']['quotient_sweep']}, fold launches "
            f"{run['launches_on_prove']['fri_fold']}")
        del run["asm"], run["setup"]
        paths[label] = run["launches"]
    del sha_asm
    # the slice: general-purpose-column lookups and witness columns at 2^20
    for phase, label, which in ((9, GEN_PATH, "general_lookup"),
                                (10, WIT_PATH, "zero_check_witness")):

        def circuit(which=which, label=label):
            res = synthesized.pop(which)
            want = res["output"]

            def check(proof):
                if proof.public_inputs != [want]:
                    raise AssertionError(f"{label}: public input {proof.public_inputs} "
                                         f"differs from the host's {want}")

            return res["asm"], check, res["synthesis_s"], res["resolver"]

        run = drive_path(torch, label, circuit, sha256_proof_config(), LOG_N, phase, True)
        t = time.perf_counter()
        prof = profile_prove(torch, prove, run["asm"], run["setup"], sha256_proof_config())
        prof.update(circuit=label, card=card, **{
            k: run[k] for k in ("synthesis_s", "resolver", "setup_s", "prove_cold_s",
                                "rounds_cold_s", "verify_s", "peak_device_memory_gib",
                                "launches_on_prove")})
        log(f"[{phase}] warm prove {prof['prove_warm_s']:.3f} s, device busy "
            f"{prof['device_busy_ms']:.1f} ms, idle share "
            f"{prof['device_idle_share']:.3f} ({time.perf_counter() - t:.1f} s)")
        if phase == 9:
            prof["streamed_against_materialized"] = stream_modes(
                torch, label, run["asm"], run.pop("setup"), sha256_proof_config())
        del run["asm"]
        run.pop("setup", None)
        profiles.append(prof)
        paths[label] = run["launches"]
    # the BabyBear prover: the fma chain (fma config) and the xor4 lookup
    # circuit (sha256's config) at 2^20 rows, then the mini-STARK
    def bb_fma():
        want = fma_chain_value(LOG_N, BABYBEAR.p)
        res = synthesized.pop("fma_babybear")

        def check(proof):
            if proof.public_inputs != [want]:
                raise AssertionError(f"{BB_FMA_PATH}: public input {proof.public_inputs} "
                                     f"differs from the host's {want}")

        return res["asm"], check, res["synthesis_s"], res["resolver"]

    def bb_xor():
        res = synthesized.pop("xor_lookup_babybear")
        want = res["output"]

        def check(proof):
            if proof.public_inputs != [want]:
                raise AssertionError(f"{BB_XOR_PATH}: public input {proof.public_inputs} "
                                     f"differs from the host's {want}")

        return res["asm"], check, res["synthesis_s"], res["resolver"]

    for phase, label, synth, cfg in ((12, BB_FMA_PATH, bb_fma, fma_proof_config()),
                                     (13, BB_XOR_PATH, bb_xor, sha256_proof_config())):
        run = drive_path(torch, label, synth, cfg, LOG_N, phase, False)
        t = time.perf_counter()
        prof = profile_prove(torch, prove, run["asm"], run["setup"], cfg)
        prof.update(circuit=label, card=card, **{
            k: run[k] for k in ("synthesis_s", "resolver", "setup_s", "prove_cold_s",
                                "rounds_cold_s", "verify_s", "peak_device_memory_gib",
                                "launches_on_prove")})
        log(f"[{phase}] warm prove {prof['prove_warm_s']:.3f} s, device busy "
            f"{prof['device_busy_ms']:.1f} ms, idle share "
            f"{prof['device_idle_share']:.3f} ({time.perf_counter() - t:.1f} s)")
        del run["asm"], run["setup"]
        profiles.append(prof)
        paths[label] = run["launches"]
    mini = drive_mini_stark(torch, BB_MINI_PATH, LOG_N, 14)
    paths[BB_MINI_PATH] = mini.pop("launches")
    profiles.append(dict(circuit=BB_MINI_PATH, card=card, **mini))
    # keccak256 at 2^18 and blake2s at 2^17 rows, synthesized by the
    # children; both stream their commits at LDE 8, as phases 5, 9 and 10 do
    for phase, label, which, log_n, message_len, host in (
            (15, KECCAK_PATH, "keccak256", HASH_LOG_N, keccak256_message_len, host_keccak256),
            (16, BLAKE_PATH, "blake2s", BLAKE_LOG_N, blake2s_message_len,
             lambda m: hashlib.blake2s(m).digest())):
        message = bench_message(message_len(log_n))

        def circuit(label=label, which=which, host=host, message=message):
            res = synthesis_child_result(label, *synthesis_children[which])

            def check(_proof):
                if res["output"] != host(message):
                    raise AssertionError(f"{label}: the circuit's digest of {len(message)} "
                                         f"bytes differs from the host's")

            return res["asm"], check, res["synthesis_s"], res["resolver"]

        cfg = sha256_proof_config()
        run = drive_path(torch, label, circuit, cfg, log_n, phase, True)
        t = time.perf_counter()
        prof = profile_prove(torch, prove, run["asm"], run["setup"], cfg)
        prof.update(circuit=label, message_bytes=len(message), card=card, **{
            k: run[k] for k in ("synthesis_s", "resolver", "setup_s", "prove_cold_s",
                                "rounds_cold_s", "verify_s", "peak_device_memory_gib",
                                "launches_on_prove")})
        log(f"[{phase}] {len(message)} B, digest checked; warm prove "
            f"{prof['prove_warm_s']:.3f} s, device busy {prof['device_busy_ms']:.1f} ms, "
            f"idle share {prof['device_idle_share']:.3f} ({time.perf_counter() - t:.1f} s)")
        del run["asm"], run["setup"]
        profiles.append(prof)
        paths[label] = run["launches"]

    # phase 17: the secp256k1 ladder at 2^18 rows, synthesized by a child;
    # its commits stream at LDE 8 (sha256's geometry, as keccak256's)
    ladder = {}

    def ladder_circuit():
        res = synthesis_child_result(LADDER_PATH, *synthesis_children["secp256k1_ladder"])
        out = res["output"]
        ladder["steps"] = out["scalar"].bit_length()

        def check(_proof):
            if out["at_infinity"] or tuple(out["affine"]) != secp256k1_mul_host(out["scalar"]):
                raise AssertionError(f"{LADDER_PATH}: the circuit's affine result differs "
                                     f"from the host's [k]G")

        return res["asm"], check, res["synthesis_s"], res["resolver"]

    cfg = sha256_proof_config()
    run = drive_path(torch, LADDER_PATH, ladder_circuit, cfg, LADDER_LOG_N, 17, True)
    t = time.perf_counter()
    prof = profile_prove(torch, prove, run["asm"], run["setup"], cfg)
    prof.update(circuit=LADDER_PATH, ladder_steps=ladder["steps"], card=card, **{
        k: run[k] for k in ("synthesis_s", "resolver", "setup_s", "prove_cold_s",
                            "rounds_cold_s", "verify_s", "peak_device_memory_gib",
                            "launches_on_prove")})
    log(f"[17] {ladder['steps']} ladder steps, [k]G checked; warm prove "
        f"{prof['prove_warm_s']:.3f} s, device busy {prof['device_busy_ms']:.1f} ms, "
        f"idle share {prof['device_idle_share']:.3f} ({time.perf_counter() - t:.1f} s)")
    del run["asm"], run["setup"]
    profiles.append(prof)
    paths[LADDER_PATH] = run["launches"]

    # phase 19: a proof of a proof, the recursion circuit over phase 7's
    # sha256 proof, synthesized by the child started after phase 7
    def rec_circuit():
        res = synthesis_child_result(REC_PATH, rec_child, rec_files[2])

        def check(proof):
            if proof.public_inputs != res["output"]:
                raise AssertionError(f"{REC_PATH}: public inputs {proof.public_inputs} "
                                     f"differ from the inner proof's {res['output']}")

        return res["asm"], check, res["synthesis_s"], res["resolver"]

    cfg = sha256_proof_config()
    run = drive_path(torch, REC_PATH, rec_circuit, cfg, REC_LOG_N, 19, False)
    t = time.perf_counter()
    prof = profile_prove(torch, prove, run["asm"], run["setup"], cfg)
    prof.update(circuit=REC_PATH, card=card, inner_public_inputs=len(inner_proof.public_inputs),
                **{k: run[k] for k in ("synthesis_s", "resolver", "setup_s", "prove_cold_s",
                                       "rounds_cold_s", "verify_s", "peak_device_memory_gib",
                                       "launches_on_prove")})
    gates = sorted({g.name for g in run["asm"].gates})
    log(f"[19] sha256 proof verified in a {run['asm'].trace_len}-row circuit (gates {gates}), "
        f"public inputs checked; warm prove {prof['prove_warm_s']:.3f} s, device busy "
        f"{prof['device_busy_ms']:.1f} ms, idle share {prof['device_idle_share']:.3f} "
        f"({time.perf_counter() - t:.1f} s)")
    del run["asm"], run["setup"]
    profiles.append(prof)
    paths[REC_PATH] = run["launches"]
    for prof in profiles:
        print(json.dumps({"profile": prof}))

    for row in rows:
        by_path = {p: c[row["name"]] for p, c in paths.items()}
        # a size row's shape is on no path: it carries the kernel's launches
        # on all of them
        row["launches"] = by_path.get(row["path"], sum(by_path.values()))
        row["launches_by_path"] = by_path
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "entry", "path", "shape",
            "bound_canonical_ms", "bound_plain_ms", "bound_rounds_ms", "bound_own_ms",
            "launches_per_call", "launches_by_path")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r} for r in rows]}))
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        for child in CHILDREN:
            if child.poll() is None:
                child.kill()
                child.wait()
        for d in TEMP_DIRS:
            shutil.rmtree(d, ignore_errors=True)
    sys.exit(code)
