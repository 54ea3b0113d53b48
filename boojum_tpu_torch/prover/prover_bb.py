"""The full PLONKish prover over BabyBear (the JAX package's
prover/prover_bb.py prove_full_babybear), with its self-check
`quotient_identity_at_z`.

The same 5-round IOP and checkpoint labels as the JAX package's BabyBear
prover, whose differences from the Goldilocks one the field forces:
- challenges live in GF(p^4): the z polynomial, the partial products and
  the lookup polynomials are 4 base columns each, and values at z are
  4-tuples;
- every commit is over PAIRED leaves (leaf j holds the columns at j and at
  j + N/2), so one path opens both points a FRI fold pairs;
- the quotient is one sweep over the whole rate-Q coset, in natural order;
- FRI folds by 2 a round and commits every layer, the DEEP codeword too;
- the proof of work grinds blake2s over the 31-bit challenge stream.

Every oracle stays on the device from round to round; the host gets what
the transcript absorbs (caps, values at z), the openings and the paths.
Leaf sponges and node layers are kernel B8; NTTs, stage 2, the sweep, the
evaluations, DEEP and the folds are plain PyTorch, as the JAX package runs
them as XLA.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cs.field_like import BBExtScalarOps
from ..cs.gates.base import TermsCollector
from ..field import babybear as bb
from ..field.spec import BABYBEAR
from ..ntt import bb_ntt
from ..transcript import BitSource, make_transcript
from . import bb_kernels as BK
from . import stages_bb as S
from .layout import chunk_columns
from .pow import blake2s_pow_grind, blake2s_pow_verify
from .proof import OracleQuery, Proof, SingleRoundQueries

SHIFT = BK.SHIFT
SWEEP_SLICE = 1 << 20  # domain points of one quotient-sweep slice
EVAL_BLOCK = 1 << 26  # int64 words of one evaluation block's temporary


def _host_cols(assembly, device) -> torch.Tensor:
    """The witness oracle's columns over H: [copy | lookup copy | witness
    columns | multiplicities]."""
    cols = [assembly.copy_cols_values]
    if assembly.num_lookup_cols:
        cols.append(assembly.lookup_cols_values)
    if assembly.num_wit_cols:
        cols.append(assembly.wit_cols_values)
    if assembly.lookups_enabled:
        cols.append(assembly.multiplicities[None, :])
    return bb.from_numpy(np.concatenate(cols, axis=0), device)


def _commit(vals_or_mono, L, cap, from_values=True):
    """(monomials, the (B, N) LDE, its tree over paired leaves)."""
    mono = bb_ntt.monomial_from_values(vals_or_mono) if from_values else vals_or_mono
    lde = bb_ntt.lde(mono, L, SHIFT)
    return mono, lde, BK.BBMerkleTree.commit(lde, cap)


def eval_at_ext(mono: torch.Tensor, zpows: torch.Tensor) -> list:
    """Each row of a (B, n) monomial stack at the ext point whose (4, n)
    power table is `zpows`, as host 4-tuples."""
    B, n = mono.shape
    out = torch.empty((B, 4), dtype=torch.int64, device=mono.device)
    zp = zpows.to(torch.int64)
    step = max(1, EVAL_BLOCK // n)
    for r0 in range(0, B, step):
        m = mono[r0 : r0 + step].to(torch.int64)
        for k in range(4):
            out[r0 : r0 + step, k] = ((m * zp[k]) % bb.P).sum(1) % bb.P
    return [tuple(int(x) for x in row) for row in out.cpu().numpy()]


def _absorb(t, values):
    for v in values:
        t.witness_field_elements([int(c) for c in v])


def prove_full_babybear(assembly, setup, config, device, log=None, clock=None) -> Proof:
    """Prove a BabyBear assembly against its setup on `device` (a resolved
    torch.device). `log` gets the checkpoint stream, `clock` the rounds."""
    checkpoint = log.add if log is not None else (lambda *_a: None)
    start = clock.start if clock is not None else (lambda _name: None)
    n = assembly.trace_len
    log_n = n.bit_length() - 1
    L = config.fri_lde_factor
    log_full = log_n + (L.bit_length() - 1)
    N = n * L
    half = N // 2
    cap = config.merkle_tree_cap_size
    geometry = assembly.geometry
    if assembly.lookup_mode == "general":
        raise ValueError("the BabyBear prover supports specialized lookup columns only")
    if not setup.vk.transcript.endswith("babybear"):
        raise ValueError(f"setup transcript {setup.vk.transcript!r} is not a BabyBear one")
    chunks = chunk_columns(assembly.num_copy_cols_total, geometry.max_allowed_constraint_degree)
    ctx = S.SweepContext(assembly, setup.selector_paths, setup.non_residues, chunks)
    Cg, Ct, W, R, width = ctx.Cg, ctx.Ct, ctx.W, ctx.R, ctx.width
    lookups = ctx.lookups
    Q = setup.vk.quotient_degree
    num_pi = len(assembly.public_inputs)
    num_lk = (R + 1) if lookups else 0
    omega = bb.omega(log_n)
    dev = str(device)

    t = make_transcript(setup.vk.transcript)
    t.witness_merkle_tree_cap(setup.vk.setup_merkle_cap)
    checkpoint(0, "setup_cap", setup.vk.setup_merkle_cap)
    pi_values = [int(v) for (_c, _r, v) in assembly.public_inputs]
    t.witness_field_elements(pi_values)
    checkpoint(0, "public_inputs", pi_values)

    # ---- round 1: witness commitment -------------------------------------
    start("round1_witness_commit")
    wit_vals = _host_cols(assembly, device)
    wit_mono, wit_lde, wit_tree = _commit(wit_vals, L, cap)
    t.witness_merkle_tree_cap(wit_tree.get_cap())
    checkpoint(1, "witness_cap", wit_tree.get_cap())
    beta = t.get_ext_challenge()
    gamma = t.get_ext_challenge()
    challenges = [beta, gamma]
    lookup_beta = lookup_gamma = bb.ZERO_S
    if lookups:
        lookup_beta = t.get_ext_challenge()
        lookup_gamma = t.get_ext_challenge()
        challenges += [lookup_beta, lookup_gamma]
    checkpoint(1, "challenges", challenges)

    # ---- round 2: copy permutation and lookups ---------------------------
    start("round2_stage2_commit")
    sigma = bb.from_numpy(setup.sigma_cols, device)
    zp = S.stage2_z_partials(wit_vals[:Ct], sigma, setup.non_residues,
                             bb.powers(omega, n, device), beta, gamma, chunks)
    del sigma
    s2_parts = [zp.reshape(-1, n)]
    if lookups:
        consts = bb.from_numpy(setup.constant_cols, device)
        tables = bb.from_numpy(assembly.stacked_table_columns(width), device)
        ab = S.lookup_polys(wit_vals[Cg : Cg + R * width], consts[ctx.Kc - 1], tables,
                            wit_vals[Ct + W], lookup_beta, lookup_gamma, R, width)
        s2_parts.append(ab.reshape(-1, n))
        del consts, tables, ab
    del zp, wit_vals
    s2_mono, s2_lde, s2_tree = _commit(torch.cat(s2_parts), L, cap)
    del s2_parts
    t.witness_merkle_tree_cap(s2_tree.get_cap())
    checkpoint(2, "stage2_cap", s2_tree.get_cap())
    alpha = t.get_ext_challenge()
    checkpoint(2, "alpha", alpha)

    # ---- round 3: the quotient, one sweep over the rate-Q coset -----------
    start("round3_quotient")
    setup_mono = setup.setup_monomials
    wit_q = bb_ntt.lde(wit_mono, Q, SHIFT)
    setup_q = bb_ntt.lde(setup_mono, Q, SHIFT)
    s2_q = bb_ntt.lde(s2_mono, Q, SHIFT)
    zs_q = bb_ntt.lde(bb.mul(s2_mono[:4], bb.powers(omega, n, device)), Q, SHIFT)  # z(w·x)
    xs_q = BK.domain_xs_bb(log_n, Q, SHIFT, dev)
    zh_inv_q = BK.zh_inv_bb(log_n, Q, SHIFT, dev)
    l0_q = S.l0_lde_bb(log_n, Q, SHIFT, dev)
    apows = bb.ext_powers_s(alpha, ctx.num_alpha)
    acc = torch.empty((4, Q * n), dtype=bb.DTYPE, device=device)
    for s0 in range(0, Q * n, SWEEP_SLICE):
        sl = slice(s0, s0 + SWEEP_SLICE)
        acc[:, sl] = S.sweep_terms(ctx, wit_q[:, sl], setup_q[:, sl], s2_q[:, sl],
                                   zs_q[:, sl], xs_q[sl], l0_q[sl], zh_inv_q[sl], apows,
                                   beta, gamma, lookup_beta, lookup_gamma)
    del wit_q, setup_q, s2_q, zs_q
    t_mono = bb_ntt.coset_descale(bb_ntt.monomial_from_values(acc), SHIFT)
    del acc
    # chunk i of T, coordinate k -> row 4i + k
    q_mono = t_mono.reshape(4, Q, n).transpose(0, 1).reshape(4 * Q, n).contiguous()
    del t_mono
    _, q_lde, q_tree = _commit(q_mono, L, cap, from_values=False)
    t.witness_merkle_tree_cap(q_tree.get_cap())
    checkpoint(3, "quotient_cap", q_tree.get_cap())
    z_chal = t.get_ext_challenge()
    checkpoint(3, "z", z_chal)

    # ---- round 4: evaluations at z, z·omega and 0 --------------------------
    start("round4_evaluations")
    zpows = bb.ext_powers(z_chal, n, device)
    values_at_z = []
    for mono in (wit_mono, setup_mono, s2_mono, q_mono):
        values_at_z += eval_at_ext(mono, zpows)
    B_all = len(values_at_z)
    zw = bb.ext_scale_s(z_chal, omega)
    values_at_z_omega = eval_at_ext(s2_mono[:4], bb.ext_powers(zw, n, device))
    del zpows
    ab_row = 4 + 4 * ctx.num_partials
    c0 = bb.to_numpy(s2_mono[ab_row : ab_row + 4 * num_lk, 0])
    values_at_0 = [tuple(int(c0[4 * i + k]) for k in range(4)) for i in range(num_lk)]
    _absorb(t, values_at_z + values_at_z_omega + values_at_0)
    checkpoint(4, "evaluations", [values_at_z, values_at_z_omega, values_at_0])
    deep_ch = t.get_ext_challenge()
    checkpoint(4, "deep_challenge", deep_ch)

    # ---- round 5: DEEP and FRI --------------------------------------------
    start("round5_deep_fri")
    ch = bb.ext_powers_s(deep_ch, B_all + 4 + num_lk + num_pi)
    at_z = bb.ZERO_S
    for i in range(B_all):
        at_z = bb.ext_add_s(at_z, bb.ext_mul_s(ch[i], values_at_z[i]))
    xs_lde = BK.domain_xs_bb(log_n, L, SHIFT, dev)
    pi_rows = [r for (_c, r, _v) in assembly.public_inputs]
    pi_cols = wit_lde[[c for (c, _r, _v) in assembly.public_inputs]] if num_pi else None
    pi_inv = (bb.inv(bb.sub(xs_lde[None, :].to(torch.int64),
                            torch.tensor([bb.pow_s(omega, r) for r in pi_rows],
                                         dtype=torch.int64, device=device)[:, None]))
              if num_pi else None)
    h = S.deep_codeword(
        [wit_lde, setup.setup_lde, s2_lde, q_lde], s2_lde[:4], s2_lde[ab_row:],
        pi_cols, xs_lde, z_chal, zw, ch, at_z, values_at_z_omega, values_at_0,
        pi_values, pi_inv)
    del pi_cols, pi_inv
    num_rounds = (n // config.fri_final_degree).bit_length() - 1
    if num_rounds < 1:
        raise ValueError("fri_final_degree leaves nothing to fold")
    fold_tables = BK.fri_fold_tables_bb(log_full, SHIFT, num_rounds, dev)
    fri_trees, fri_layers, cur = [], [], h
    for r in range(num_rounds):
        fri_layers.append(cur)
        tree = BK.BBMerkleTree.commit(cur, min(cap, cur.shape[-1] // 2))
        fri_trees.append(tree)
        t.witness_merkle_tree_cap(tree.get_cap())
        checkpoint(5, f"fri_cap_{r}", tree.get_cap())
        beta_r = t.get_ext_challenge()
        checkpoint(5, f"fri_challenge_{r}", beta_r)
        cur = BK.fri_fold_bb(cur, beta_r, fold_tables[r])
    final_mono = bb.to_numpy(bb_ntt.coset_descale(
        bb_ntt.monomial_from_values(cur), bb.pow_s(SHIFT, 1 << num_rounds)))
    final_fri_monomials = [tuple(int(final_mono[k][i]) for k in range(4))
                           for i in range(config.fri_final_degree)]
    _absorb(t, final_fri_monomials)
    checkpoint(5, "fri_final_monomials", final_fri_monomials)
    pow_nonce = blake2s_pow_grind(t, config.pow_bits)
    checkpoint(5, "pow_nonce", [pow_nonce])

    # ---- queries ----------------------------------------------------------
    start("queries")
    bs = BitSource(log_full, challenge_bits=BABYBEAR.challenge_bits)
    idxs = [bs.get_index(t, log_full) for _ in range(config.num_queries)]
    checkpoint(5, "query_indices", idxs)
    j0 = [pos % half for pos in idxs]
    j0_dev = torch.tensor(j0, dtype=torch.int64, device=device)

    def oracle_queries(lde, tree):
        vals = bb.to_numpy(torch.cat([lde[:, j0_dev], lde[:, j0_dev + half]]))
        paths = tree.get_paths(j0)
        return [OracleQuery(leaf_values=[int(x) for x in vals[:, q]], path=paths[q])
                for q in range(len(idxs))]

    wit_qs = oracle_queries(wit_lde, wit_tree)
    s2_qs = oracle_queries(s2_lde, s2_tree)
    q_qs = oracle_queries(q_lde, q_tree)
    setup_qs = oracle_queries(setup.setup_lde, setup.setup_tree)
    fri_qs = []
    p = list(idxs)
    for layer, tree in zip(fri_layers, fri_trees):
        h_r = layer.shape[-1] // 2
        leaf = [q % h_r for q in p]
        ld = torch.tensor(leaf, dtype=torch.int64, device=device)
        vals = bb.to_numpy(torch.cat([layer[:, ld], layer[:, ld + h_r]]))  # (8, q)
        paths = tree.get_paths(leaf)
        fri_qs.append([OracleQuery(leaf_values=[int(x) for x in vals[:, q]], path=paths[q])
                       for q in range(len(idxs))])
        p = leaf
    if clock is not None:
        clock.stop()

    return Proof(
        public_inputs=pi_values,
        witness_cap=wit_tree.get_cap(),
        stage2_cap=s2_tree.get_cap(),
        quotient_cap=q_tree.get_cap(),
        values_at_z=values_at_z,
        values_at_z_omega=values_at_z_omega,
        values_at_0=values_at_0,
        fri_caps=[tr.get_cap() for tr in fri_trees],
        final_fri_monomials=final_fri_monomials,
        queries=[
            SingleRoundQueries(witness=wit_qs[q], stage2=s2_qs[q], quotient=q_qs[q],
                               setup=setup_qs[q], fri=[f[q] for f in fri_qs])
            for q in range(len(idxs))
        ],
        pow_challenge=pow_nonce,
        config={
            "fri_lde_factor": L,
            "quotient_degree": Q,
            "merkle_tree_cap_size": cap,
            "num_queries": config.num_queries,
            "pow_bits": config.pow_bits,
            "fri_final_degree": config.fri_final_degree,
            "field": "babybear",
        },
    )


# ---------------------------------------------------------------------------
# The quotient identity at z, from the proof's own openings
# ---------------------------------------------------------------------------


def _replay(assembly, setup, proof, through_queries: bool = False) -> dict:
    """Every challenge up to the DEEP one, re-derived from the proof as a
    verifier would; with `through_queries`, the FRI challenges, the proof
    of work's check ("pow") and the query indices too."""
    t = make_transcript(setup.vk.transcript)
    t.witness_merkle_tree_cap(setup.vk.setup_merkle_cap)
    t.witness_field_elements([int(v) for v in proof.public_inputs])
    t.witness_merkle_tree_cap(proof.witness_cap)
    out = {"beta": t.get_ext_challenge(), "gamma": t.get_ext_challenge()}
    if assembly.lookups_enabled:
        out["lookup_beta"] = t.get_ext_challenge()
        out["lookup_gamma"] = t.get_ext_challenge()
    t.witness_merkle_tree_cap(proof.stage2_cap)
    out["alpha"] = t.get_ext_challenge()
    t.witness_merkle_tree_cap(proof.quotient_cap)
    out["z"] = t.get_ext_challenge()
    _absorb(t, list(proof.values_at_z) + list(proof.values_at_z_omega)
            + list(proof.values_at_0))
    out["deep"] = t.get_ext_challenge()
    if through_queries:
        out["fri"] = []
        for cap in proof.fri_caps:
            t.witness_merkle_tree_cap(cap)
            out["fri"].append(t.get_ext_challenge())
        _absorb(t, proof.final_fri_monomials)
        out["pow"] = blake2s_pow_verify(t, setup.vk.pow_bits, proof.pow_challenge)
        log_full = (assembly.trace_len * setup.vk.fri_lde_factor).bit_length() - 1
        bs = BitSource(log_full, challenge_bits=BABYBEAR.challenge_bits)
        out["query_indices"] = [bs.get_index(t, log_full) for _ in range(setup.vk.num_queries)]
    return out


def query_paths_hold(assembly, setup, proof) -> bool:
    """The proof of work, and every opened leaf of every query (the four
    oracles at the query's point, each FRI layer at its folded point)
    checked against its cap with verify_path_bb."""
    chs = _replay(assembly, setup, proof, through_queries=True)
    if not chs["pow"] or len(proof.queries) != len(chs["query_indices"]):
        return False
    half = assembly.trace_len * setup.vk.fri_lde_factor // 2
    caps = {"witness": proof.witness_cap, "stage2": proof.stage2_cap,
            "quotient": proof.quotient_cap, "setup": setup.vk.setup_merkle_cap}
    for pos, q in zip(chs["query_indices"], proof.queries):
        for name, cap in caps.items():
            oq = getattr(q, name)
            if not BK.verify_path_bb(oq.leaf_values, oq.path, cap, pos % half):
                return False
        if len(q.fri) != len(proof.fri_caps):
            return False
        p, h_r = pos, half
        for oq, cap in zip(q.fri, proof.fri_caps):
            p %= h_r
            if not BK.verify_path_bb(oq.leaf_values, oq.path, cap, p):
                return False
            h_r //= 2
    return True


def _group_ext(vals, idx):
    """The ext value of ext polynomial `idx` from its 4 base columns'
    values: sum_k w^k·col_k(z)."""
    out = bb.ZERO_S
    for k in range(4):
        basis = tuple(1 if j == k else 0 for j in range(4))
        out = bb.ext_add_s(out, bb.ext_mul_s(basis, vals[4 * idx + k]))
    return out


def quotient_identity_at_z(assembly, setup, proof) -> bool:
    """acc(z) == T(z)·(z^n - 1): the alpha-weighted constraint sum at z,
    rebuilt from the proof's openings with the gates' own evaluators over
    GF(p^4) scalars, against the committed quotient chunks at z."""
    n = assembly.trace_len
    chunks = chunk_columns(assembly.num_copy_cols_total,
                           assembly.geometry.max_allowed_constraint_degree)
    ctx = S.SweepContext(assembly, setup.selector_paths, setup.non_residues, chunks)
    Cg, Ct, W, Kc, R, width = ctx.Cg, ctx.Ct, ctx.W, ctx.Kc, ctx.R, ctx.width
    lookups = ctx.lookups
    Q = setup.vk.quotient_degree
    chs = _replay(assembly, setup, proof)
    z = tuple(int(c) for c in chs["z"])
    vz = [tuple(int(c) for c in v) for v in proof.values_at_z]
    B_wit = Ct + W + (1 if lookups else 0)
    B_setup = Ct + Kc + ((width + 1) if lookups else 0)
    if len(vz) < B_wit + B_setup + 4 * Q:
        return False
    wit_z = vz[:B_wit]
    setup_z = vz[B_wit : B_wit + B_setup]
    s2_z = vz[B_wit + B_setup : len(vz) - 4 * Q]
    q_z = vz[len(vz) - 4 * Q :]
    sigma_z, const_z, table_z = setup_z[:Ct], setup_z[Ct : Ct + Kc], setup_z[Ct + Kc :]
    z_pow_n = bb.ext_pow_s(z, n)
    zh_z = bb.ext_sub_s(z_pow_n, bb.ONE_S)
    z_v = _group_ext(s2_z, 0)
    partial_v = [_group_ext(s2_z, 1 + j) for j in range(ctx.num_partials)]
    z_shift_v = _group_ext([tuple(int(c) for c in v) for v in proof.values_at_z_omega], 0)
    ap = iter(bb.ext_powers_s(tuple(int(c) for c in chs["alpha"]), ctx.num_alpha))
    acc = bb.ZERO_S

    class _Row:
        def __init__(self, vo, wo, ko):
            self.vo, self.wo, self.ko = vo, wo, ko

        def v(self, i):
            return wit_z[self.vo + i]

        def w(self, i):
            return wit_z[Ct + self.wo + i]

        def c(self, i):
            return const_z[self.ko + i]

    for gid, gate in enumerate(assembly.gates):
        if gate.num_terms == 0:
            continue
        path = setup.selector_paths[gid]
        sel = bb.ONE_S
        for b, bit in enumerate(path):
            sel = bb.ext_mul_s(sel, const_z[b] if bit else bb.ext_sub_s(bb.ONE_S, const_z[b]))
        gate_acc = bb.ZERO_S
        for inst in range(gate.num_repetitions(assembly.geometry)):
            dst = TermsCollector()
            gate.evaluate(BBExtScalarOps,
                          _Row(inst * gate.principal_width, inst * gate.witness_width,
                               len(path)), dst)
            for term in dst.terms:
                gate_acc = bb.ext_add_s(gate_acc, bb.ext_mul_s(term, next(ap)))
        acc = bb.ext_add_s(acc, bb.ext_mul_s(gate_acc, sel))
    beta = tuple(int(c) for c in chs["beta"])
    gamma = tuple(int(c) for c in chs["gamma"])
    l0_z = bb.ext_mul_s(zh_z, bb.ext_inv_s(bb.ext_scale_s(bb.ext_sub_s(z, bb.ONE_S), n)))
    acc = bb.ext_add_s(acc, bb.ext_mul_s(bb.ext_mul_s(l0_z, bb.ext_sub_s(z_v, bb.ONE_S)),
                                         next(ap)))
    lhs_seq = partial_v + [z_shift_v]
    rhs_seq = [z_v] + partial_v
    for j, chunk in enumerate(chunks):
        num_p = den_p = bb.ONE_S
        for col in chunk:
            kx = bb.ext_scale_s(z, int(setup.non_residues[col]))
            num = bb.ext_add_s(bb.ext_add_s(wit_z[col], bb.ext_mul_s(beta, kx)), gamma)
            den = bb.ext_add_s(bb.ext_add_s(wit_z[col], bb.ext_mul_s(beta, sigma_z[col])),
                               gamma)
            num_p = bb.ext_mul_s(num_p, num)
            den_p = bb.ext_mul_s(den_p, den)
        term = bb.ext_sub_s(bb.ext_mul_s(lhs_seq[j], den_p), bb.ext_mul_s(rhs_seq[j], num_p))
        acc = bb.ext_add_s(acc, bb.ext_mul_s(term, next(ap)))
    if lookups:
        lkb = tuple(int(c) for c in chs["lookup_beta"])
        gpow = bb.ext_powers_s(tuple(int(c) for c in chs["lookup_gamma"]), width + 1)
        ab_off = 1 + ctx.num_partials

        def aggregate(vals, tid):
            den = lkb
            for j, v in enumerate(vals):
                den = bb.ext_add_s(den, bb.ext_mul_s(v, gpow[j]))
            return bb.ext_add_s(den, bb.ext_mul_s(tid, gpow[width]))

        for i in range(R):
            den = aggregate(wit_z[Cg + i * width : Cg + (i + 1) * width], const_z[Kc - 1])
            term = bb.ext_sub_s(bb.ext_mul_s(_group_ext(s2_z, ab_off + i), den), bb.ONE_S)
            acc = bb.ext_add_s(acc, bb.ext_mul_s(term, next(ap)))
        t_den = aggregate(table_z[:width], table_z[width])
        term = bb.ext_sub_s(bb.ext_mul_s(_group_ext(s2_z, ab_off + R), t_den), wit_z[Ct + W])
        acc = bb.ext_add_s(acc, bb.ext_mul_s(term, next(ap)))
    # T(z): chunk i of the quotient is sum_k w^k·q_{4i+k}(z), weighted z^(n·i)
    t_z = bb.ZERO_S
    zn_pow = bb.ONE_S
    for i in range(Q):
        t_z = bb.ext_add_s(t_z, bb.ext_mul_s(_group_ext(q_z, i), zn_pow))
        zn_pow = bb.ext_mul_s(zn_pow, z_pow_n)
    return acc == bb.ext_mul_s(t_z, zh_z)
