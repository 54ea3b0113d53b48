"""The 5-round IOP prover on one device (the JAX package's prover.py
_prove_impl, meshless, with witness columns and lookups in specialized or
general-purpose columns, materialized or streamed).

Rounds (the transcript order is the protocol; the verifier replays it):
  0. absorb the setup cap and the public inputs
  1. commit the witness columns (monomials -> coset LDE -> Merkle)
                                     ... beta, gamma (+ lookup beta', gamma')
  2. commit stage 2 (copy-permutation z and partial products, lookup A_i
     and B)                                                       ... alpha
  3. commit the quotient chunks (per-coset sweep, interpolate)    ... z
  4. absorb the evaluations at z, z·omega (the grand product) and 0 (the
     lookup polynomials)                                          ... DEEP
  5. DEEP codeword -> FRI -> proof of work -> query openings

Oracles: witness [general copy | lookup copy | witness columns |
multiplicities]; setup [sigma | constants (+ table id) | table columns];
stage 2 [z | partials | A_i | B], each ext polynomial as its (c0, c1) base
column pair; quotient [q_0 c0, q_0 c1, ...], as prover/layout.py lays them
out. Every polynomial op runs on the device: the kernels carry the NTTs,
LDEs, Merkle hashing, quotient sweep and FRI folds, plain PyTorch the rest;
the host runs the transcript and assembles queries.

Past the stream threshold (prover/streaming.py, the JAX package's rule on
its own column estimate) the witness, stage-2 and quotient commits stream:
the prover keeps their monomials and no LDE, and round 5 regenerates the
columns it reads (DEEP blocks, single columns, query openings). The setup
oracle follows how the setup was committed.

Each transcript step reports (round, label, values) to `log` with the same
labels as the JAX package's prover, so the two checkpoint streams compare
entry for entry.
"""

from __future__ import annotations

import time
from functools import lru_cache

import numpy as np
import torch

from .. import resolve_device
from ..field import extension as ext_f
from ..field import gl
from ..field import goldilocks as gf
from ..merkle import MerkleTreeWithCap, commit_layers_device
from ..ntt import (
    bitreverse_indices,
    distribute_powers,
    eval_monomial_at_ext_point,
    fft_natural_to_bitreversed,
    ifft_bitreversed_to_natural,
    lde_from_monomial,
    lde_scale_rows,
    monomial_from_values,
    powers_device,
)
from ..transcript import BitSource, make_transcript
from .config import ProofConfig
from .fri import fri_prove
from .pow import pow_grind
from .proof import OracleQuery, Proof, SingleRoundQueries
from .layout import OracleLayout
from .quotient_sweep import SweepPlan, coset_terms, selector_from_consts, sweep_table
from .stages import compute_lookup_polys, compute_lookup_polys_general, stage2_columns
from .streaming import (
    STREAM_THRESHOLD_BYTES,
    MonomialSource,
    commit_streaming,
    deep_source_blocks,
    use_streamed_lde,
)

DEEP_BLOCK_BYTES = 128 << 20  # bytes of materialized columns per DEEP block


@lru_cache(maxsize=4)
def _domain_tables(log_n: int, lde_factor: int, device: str):
    """(x, L0(x), 1/Z_H(x)) over the rate-`lde_factor` domain g·<w_N>, in
    bit-reversed order (so slice c·n:(c+1)·n is coset c), built on the
    device."""
    n = 1 << log_n
    log_lde = lde_factor.bit_length() - 1
    log_full = log_n + log_lde
    w_full = gl.omega(log_full)
    xs = gf.mul(gf.powers(w_full, n << log_lde, device),
                gl.MULTIPLICATIVE_GENERATOR)[bitreverse_indices(log_full, device)]
    # Z_H(x) = x^n - 1 is one constant per coset
    zh, zh_inv = [], []
    for jb in bitreverse_indices(log_lde).tolist():
        shift = gl.mul(gl.MULTIPLICATIVE_GENERATOR, gl.pow_(w_full, jb))
        zh.append(gl.sub(gl.pow_(shift, n), 1))
        zh_inv.append(gl.inv(zh[-1]))

    def per_coset(vals):
        words = torch.tensor([gf.as_i64(v) for v in vals], dtype=torch.int64,
                             device=device)
        return words.repeat_interleave(n)

    # L0(x) = (x^n - 1) / (n (x - 1))
    l0 = gf.mul(gf.mul(per_coset(zh), gl.inv(n)), gf.batch_inverse(gf.sub(xs, 1)))
    return xs, l0, per_coset(zh_inv)


@lru_cache(maxsize=4)
def _inv_xs(log_n: int, lde_factor: int, device: str):
    """1/x over the rate-`lde_factor` domain, bit-reversed like
    _domain_tables: x^-1 = g^-1·w^-k, built on the device."""
    log_full = log_n + lde_factor.bit_length() - 1
    w_inv = gl.inv(gl.omega(log_full))
    return gf.mul(gf.powers(w_inv, 1 << log_full, device),
                  gl.inv(gl.MULTIPLICATIVE_GENERATOR))[bitreverse_indices(log_full, device)]


def _commit(values_or_mono, L, cap, stream, from_values=True):
    """(monomials, the (B, L·n) LDE or, streamed, a MonomialSource, tree)."""
    mono = monomial_from_values(values_or_mono) if from_values else values_or_mono
    if stream:
        return mono, MonomialSource(mono, L), commit_streaming(mono, L, cap)
    lde = lde_from_monomial(mono, L)
    tree = MerkleTreeWithCap(commit_layers_device(lde, cap), cap)
    return mono, lde.reshape(lde.shape[0], -1), tree


def _columns(src, idxs):
    """Rows idxs of an oracle's (B, N) LDE, regenerated if it streams."""
    if isinstance(src, MonomialSource):
        return src.columns(idxs)
    return src[torch.as_tensor(list(idxs), dtype=torch.int64, device=src.device)]


def _leaf_values(src, idx):
    """(B, len(idx)) leaf values of an oracle at the LDE points idx."""
    return src.gather_rows(idx) if isinstance(src, MonomialSource) else src[:, idx]


class _Clock:
    """Per-round wall seconds (device synchronised) into `timings`."""

    def __init__(self, timings, device):
        self.timings = timings
        self.device = device
        self.name = None
        self.t0 = None

    def start(self, name):
        self.stop()
        if self.timings is not None:
            self.name, self.t0 = name, time.perf_counter()

    def stop(self):
        if self.name is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings[self.name] = time.perf_counter() - self.t0
        self.name = None


def prove(assembly, setup, config: ProofConfig, device="cuda", log=None,
          timings=None, stream_threshold_bytes=STREAM_THRESHOLD_BYTES) -> Proof:
    """Prove `assembly` against `setup` on `device`. `log`, if given, gets
    the checkpoint stream (utils/report.CheckpointLog); `timings`, if given,
    a dict, gets each round's wall seconds. The commits stream when the
    JAX package's estimate of the oracles' LDE storage passes
    `stream_threshold_bytes` (0 always, math.inf never). A BabyBear
    assembly goes to prover_bb.prove_full_babybear, which never streams."""
    device = resolve_device(device)
    clock = _Clock(timings, device)
    if getattr(assembly, "field", "goldilocks") == "babybear":
        from .prover_bb import prove_full_babybear

        return prove_full_babybear(assembly, setup, config, device, log, clock)
    checkpoint = log.add if log is not None else (lambda *_a: None)
    n = assembly.trace_len
    log_n = n.bit_length() - 1
    L = config.fri_lde_factor
    log_full = log_n + (L.bit_length() - 1)
    N = n * L
    cap = config.merkle_tree_cap_size
    geometry = assembly.geometry
    layout = OracleLayout.for_assembly(assembly, setup.selector_paths)
    Ct = layout.Ct
    lookups = layout.lookups
    R = layout.R
    Q = setup.vk.quotient_degree
    omega = gl.omega(log_n)
    stream = use_streamed_lde(layout.streamed_columns_estimate(Q, L), N,
                              stream_threshold_bytes)

    t = make_transcript(setup.vk.transcript)
    t.witness_merkle_tree_cap(setup.vk.setup_merkle_cap)
    checkpoint(0, "setup_cap", setup.vk.setup_merkle_cap)
    pi_values = [v for (_c, _r, v) in assembly.public_inputs]
    t.witness_field_elements(pi_values)
    checkpoint(0, "public_inputs", pi_values)

    # ---- round 1: witness commitment -------------------------------------
    clock.start("round1_witness_commit")
    host_cols = [assembly.copy_cols_values]
    if layout.specialized:
        host_cols.append(assembly.lookup_cols_values)
    if layout.W:
        host_cols.append(assembly.wit_cols_values)
    if lookups:
        host_cols.append(assembly.multiplicities[None, :])
    wit_vals = gf.from_numpy(np.concatenate(host_cols, axis=0), device)
    wit_mono, wit_src, wit_tree = _commit(wit_vals, L, cap, stream)
    t.witness_merkle_tree_cap(wit_tree.get_cap())
    checkpoint(1, "witness_cap", wit_tree.get_cap())
    beta = t.get_ext_challenge()
    gamma = t.get_ext_challenge()
    challenges = [beta, gamma]
    lookup_beta = lookup_gamma = None
    if lookups:
        lookup_beta = t.get_ext_challenge()
        lookup_gamma = t.get_ext_challenge()
        challenges += [lookup_beta, lookup_gamma]
    checkpoint(1, "challenges", challenges)

    # ---- round 2: copy-permutation stage 2 -------------------------------
    clock.start("round2_stage2_commit")
    s2_vals = stage2_columns(
        wit_vals[:Ct], gf.from_numpy(setup.sigma_cols, device), setup.non_residues,
        powers_device(omega, n, device), beta, gamma,
        geometry.max_allowed_constraint_degree,
    )
    if lookups:
        consts = gf.from_numpy(setup.constant_cols, device)
        tables = gf.from_numpy(assembly.stacked_table_columns(layout.width), device)
        tuples = wit_vals[layout.lookup_col_base : layout.lookup_col_base + R * layout.width]
        lk_args = (tuples, consts[layout.tid_const], tables, wit_vals[layout.mult_row])
        lk_challenges = (lookup_beta, lookup_gamma, R, layout.width)
        if layout.specialized:
            a_polys, b_poly = compute_lookup_polys(*lk_args, *lk_challenges)
        else:
            # the marker selector over H, from the constant columns
            sel = selector_from_consts(consts, layout.marker_path)
            a_polys, b_poly = compute_lookup_polys_general(*lk_args, sel, *lk_challenges)
        del consts, tables
        s2_vals = torch.cat(
            [s2_vals, torch.stack([c for p in [*a_polys, b_poly] for c in p])]
        )
        del a_polys, b_poly
    del wit_vals
    s2_mono, s2_src, s2_tree = _commit(s2_vals, L, cap, stream)
    del s2_vals
    t.witness_merkle_tree_cap(s2_tree.get_cap())
    checkpoint(2, "stage2_cap", s2_tree.get_cap())
    alpha = t.get_ext_challenge()
    checkpoint(2, "alpha", alpha)

    # ---- round 3: quotient, one coset at a time at rate Q ----------------
    clock.start("round3_quotient")
    zs_mono = gf.mul(s2_mono[:2], powers_device(omega, n, device))  # z(w·x)
    xs_q, l0_q, zh_inv_q = _domain_tables(log_n, Q, str(device))
    scale_q = lde_scale_rows(log_n, Q, device)
    plan = SweepPlan(assembly.gates, setup.selector_paths, geometry, Ct, device,
                     assembly.lookup_params if lookups else None)
    table = sweep_table(plan, alpha, beta, gamma, setup.non_residues, device,
                        lookup_beta, lookup_gamma)
    parts0, parts1 = [], []
    for c in range(Q):
        row = scale_q[c]
        sl = slice(c * n, (c + 1) * n)
        t0c, t1c = coset_terms(
            plan,
            fft_natural_to_bitreversed(wit_mono, row),
            fft_natural_to_bitreversed(setup.setup_monomials, row),
            fft_natural_to_bitreversed(s2_mono, row),
            fft_natural_to_bitreversed(zs_mono, row),
            xs_q[sl], l0_q[sl], zh_inv_q[sl], table,
        )
        parts0.append(t0c)
        parts1.append(t1c)
    g_inv = gl.inv(gl.MULTIPLICATIVE_GENERATOR)
    T_mono = [
        distribute_powers(ifft_bitreversed_to_natural(torch.cat(p)), g_inv)
        for p in (parts0, parts1)
    ]
    del parts0, parts1
    q_mono = torch.stack(
        [T_mono[comp][i * n : (i + 1) * n] for i in range(Q) for comp in (0, 1)]
    )
    del T_mono
    _, q_src, q_tree = _commit(q_mono, L, cap, stream, from_values=False)
    t.witness_merkle_tree_cap(q_tree.get_cap())
    checkpoint(3, "quotient_cap", q_tree.get_cap())
    z_chal = t.get_ext_challenge()
    checkpoint(3, "z", z_chal)

    # ---- round 4: evaluations at z and z·omega ----------------------------
    clock.start("round4_evaluations")
    all_mono = torch.cat([wit_mono, setup.setup_monomials, s2_mono, q_mono])
    B = all_mono.shape[0]
    zw = ext_f.mul_by_base_s(z_chal, omega)
    ev0, ev1 = eval_monomial_at_ext_point(all_mono, z_chal)
    evw0, evw1 = eval_monomial_at_ext_point(s2_mono[:2], zw)
    del all_mono
    values_at_z = [(int(a), int(b)) for a, b in zip(gf.to_numpy(ev0), gf.to_numpy(ev1))]
    values_at_z_omega = [
        (int(a), int(b)) for a, b in zip(gf.to_numpy(evw0), gf.to_numpy(evw1))
    ]
    # the lookup polynomials at 0 are their constant monomial coefficients
    ab = layout.ab_row
    c0 = gf.to_numpy(s2_mono[ab:, 0])
    values_at_0 = [(int(c0[2 * i]), int(c0[2 * i + 1]))
                   for i in range(layout.num_values_at_0)]
    for v in values_at_z + values_at_z_omega + values_at_0:
        t.witness_field_elements(v)
    checkpoint(4, "evaluations", [values_at_z, values_at_z_omega, values_at_0])
    deep_ch = t.get_ext_challenge()
    checkpoint(4, "deep_challenge", deep_ch)

    # ---- round 5: DEEP + FRI ---------------------------------------------
    clock.start("round5_deep_fri")
    # a streamed setup streams here too, whatever this prove's threshold
    setup_src = (MonomialSource(setup.setup_monomials, L) if setup.setup_lde is None
                 else setup.setup_lde.reshape(-1, N))
    # z at z·omega, A_i and B at 0, and the public-input columns
    s2_cols = _columns(s2_src, [0, 1, *range(ab, ab + 2 * len(values_at_0))])
    pi_cols = (_columns(wit_src, [c for (c, _r, _v) in assembly.public_inputs])
               if assembly.public_inputs else None)
    h = _deep_codeword(
        [wit_src, setup_src, s2_src, q_src], s2_cols, pi_cols, assembly, log_n, L,
        device, values_at_z, values_at_z_omega, values_at_0, z_chal, zw, deep_ch,
        omega, B,
    )
    del s2_cols, pi_cols
    fri = fri_prove(h, t, config, n, checkpoint)
    del h
    pow_nonce = pow_grind(t, config.pow_bits)
    checkpoint(5, "pow_nonce", [pow_nonce])

    # ---- queries ----------------------------------------------------------
    clock.start("queries")
    bs = BitSource(log_full)
    idxs = [bs.get_index(t, log_full) for _ in range(config.num_queries)]
    checkpoint(5, "query_indices", idxs)
    idx_dev = torch.tensor(idxs, dtype=torch.int64, device=device)

    def oracle_queries(src, tree):
        vals = gf.to_numpy(_leaf_values(src, idx_dev))
        paths = tree.get_proofs(idxs)
        return [
            OracleQuery(leaf_values=[int(x) for x in vals[:, q]], path=paths[q])
            for q in range(len(idxs))
        ]

    wit_qs = oracle_queries(wit_src, wit_tree)
    s2_qs = oracle_queries(s2_src, s2_tree)
    q_qs = oracle_queries(q_src, q_tree)
    setup_qs = oracle_queries(setup_src, setup.setup_tree)
    fri_qs = []
    fidxs = np.array(idxs, dtype=np.int64)
    for r, tree in enumerate(fri.trees):
        block = 1 << fri.schedule[r]
        leaf_idx = fidxs >> fri.schedule[r]
        rows = (leaf_idx[:, None] * block + np.arange(block)[None, :]).reshape(-1)
        rows_dev = torch.from_numpy(rows).to(device)
        v0, v1 = fri.values[r]
        g0 = gf.to_numpy(v0[rows_dev])
        g1 = gf.to_numpy(v1[rows_dev])
        paths = tree.get_proofs(leaf_idx.tolist())
        fri_qs.append([
            OracleQuery(
                leaf_values=[
                    int(g[q * block + j]) for j in range(block) for g in (g0, g1)
                ],
                path=paths[q],
            )
            for q in range(len(idxs))
        ])
        fidxs = leaf_idx
    clock.stop()

    queries = [
        SingleRoundQueries(
            witness=wit_qs[q], stage2=s2_qs[q], quotient=q_qs[q],
            setup=setup_qs[q], fri=[fri_qs[r][q] for r in range(len(fri.trees))],
        )
        for q in range(len(idxs))
    ]
    return Proof(
        public_inputs=pi_values,
        witness_cap=wit_tree.get_cap(),
        stage2_cap=s2_tree.get_cap(),
        quotient_cap=q_tree.get_cap(),
        values_at_z=values_at_z,
        values_at_z_omega=values_at_z_omega,
        values_at_0=values_at_0,
        fri_caps=[tr.get_cap() for tr in fri.trees],
        final_fri_monomials=fri.final_monomials,
        queries=queries,
        pow_challenge=pow_nonce,
        config={
            "fri_lde_factor": L,
            "quotient_degree": Q,
            "merkle_tree_cap_size": cap,
            "num_queries": config.num_queries,
            "pow_bits": config.pow_bits,
            "fri_final_degree": config.fri_final_degree,
        },
    )


def _deep_codeword(sources, s2_cols, pi_cols, assembly, log_n, L, device, values_at_z,
                   values_at_z_omega, values_at_0, z, zw, deep_ch, omega, B):
    """h(x) = Σ_i ch^i (f_i(x) - f_i(z)) / (x - z)
            + Σ_{i<2} ch^(B+i) (z_i(x) - z_i(zw)) / (x - zw)
            + Σ_i ch^(B+2+i) (f_i(x) - f_i(0)) / x  (A_i and B)
            + Σ_k ch^(B+2+lk+k) (w_col(x) - pi_k) / (x - w^row_k),
    over the full LDE domain (bit-reversed), as an ext pair. `sources` are
    the four oracles in order, each a (B_k, N) tensor or a MonomialSource;
    s2_cols holds z's two columns, then A_i's and B's, pi_cols the
    public-input columns."""
    xs, _l0, _zh = _domain_tables(log_n, L, str(device))
    num_pi = len(assembly.public_inputs)
    num_lk = len(values_at_0)
    pows = ext_f.powers_s(deep_ch, B + 2 + num_lk + num_pi)
    # 1/(x - z) and 1/(x - zw) in one stacked batch inversion
    d0 = torch.stack([gf.sub(xs, z[0]), gf.sub(xs, zw[0])])
    d1 = torch.stack([
        torch.full_like(xs, gf.as_i64(gl.neg(z[1]))),
        torch.full_like(xs, gf.as_i64(gl.neg(zw[1]))),
    ])
    inv0, inv1 = ext_f.batch_inverse((d0, d1))
    inv_xz, inv_xzw = (inv0[0], inv1[0]), (inv0[1], inv1[1])

    t0 = t1 = None
    for blk, off in deep_source_blocks(sources, DEEP_BLOCK_BYTES):
        for j, col in enumerate(blk):
            c0, c1 = pows[off + j]
            a0, a1 = gf.mul(col, c0), gf.mul(col, c1)
            t0 = a0 if t0 is None else gf.add(t0, a0)
            t1 = a1 if t1 is None else gf.add(t1, a1)
    # subtract Σ ch^i·y_i, a host scalar
    ysum = ext_f.ZERO_S
    for j in range(B):
        ysum = ext_f.add_s(ysum, ext_f.mul_s(pows[j], values_at_z[j]))
    h = ext_f.mul((gf.sub(t0, ysum[0]), gf.sub(t1, ysum[1])), inv_xz)

    for j in range(2):
        y = values_at_z_omega[j]
        num = (gf.sub(s2_cols[j], y[0]), torch.full_like(xs, gf.as_i64(gl.neg(y[1]))))
        h = ext_f.add(h, ext_f.mul(ext_f.mul(num, inv_xzw), pows[B + j]))
    if num_lk:
        inv_x = _inv_xs(log_n, L, str(device))
        for i, (y0, y1) in enumerate(values_at_0):
            num = (gf.sub(s2_cols[2 + 2 * i], y0), gf.sub(s2_cols[3 + 2 * i], y1))
            h = ext_f.add(h, ext_f.mul(ext_f.mul_by_base(num, inv_x), pows[B + 2 + i]))
    if num_pi:
        pts = np.array([gl.pow_(omega, r) for (_c, r, _v) in assembly.public_inputs],
                       dtype=np.uint64)
        denoms = gf.batch_inverse(gf.sub(xs[None, :], gf.from_numpy(pts, device)[:, None]))
        for k, (_col, _row, value) in enumerate(assembly.public_inputs):
            ch = pows[B + 2 + num_lk + k]
            term = gf.mul(gf.sub(pi_cols[k], value), denoms[k])
            h = ext_f.add(h, (gf.mul(term, ch[0]), gf.mul(term, ch[1])))
    return h
