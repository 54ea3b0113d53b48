"""Plain host verifier (python ints), the JAX package's prover/verifier.py:
transcript replay, the quotient identity at z through the same gate
evaluators (over GF(p^2) scalars, witness columns included), the
copy-permutation and lookup relations at z (specialized or general mode,
where each A relation is gated by the marker's selector), the lookup sum
check Σ_i A_i(0) = B(0), then per query the Merkle paths, the DEEP value
and the FRI chain. Column positions come from prover/layout.py.
"""

from __future__ import annotations

from ..cs.field_like import ExtScalarOps
from ..cs.gates.base import TermsCollector
from ..field import extension as ext_f
from ..field import gl
from ..merkle import verify_proof_over_cap
from ..transcript import BitSource, make_transcript
from .fri import _brev, fold_schedule, fri_verify_queries
from .layout import OracleLayout
from .pow import pow_verify
from .setup import non_residues_for_copy_permutation

W_EXT = (0, 1)  # the extension generator w, w^2 = 7


class _ZRowView:
    """Gate instance cells from the values at z: copy cells from the copy
    columns, witness cells from the witness columns after them."""

    def __init__(self, wit_vals, const_vals, var_off, wit_off, const_off):
        self.v = lambda i: wit_vals[var_off + i]
        self.w = lambda i: wit_vals[wit_off + i]
        self.c = lambda i: const_vals[const_off + i]


def ext_from_pair(c0, c1):
    """Value of an ext-coefficient polynomial from its two base openings."""
    return ext_f.add_s(c0, ext_f.mul_s(c1, W_EXT))


def _powers_iter(a):
    cur = ext_f.ONE_S
    a = (int(a[0]), int(a[1]))
    while True:
        yield cur
        cur = ext_f.mul_s(cur, a)


def verify(vk, proof, gates) -> bool:
    if vk.transcript.endswith("babybear"):
        # as in the JAX package: a full BabyBear proof has no verifier, its
        # check is prover_bb.quotient_identity_at_z with the query paths
        raise ValueError(f"verify takes Goldilocks proofs; this key's transcript is "
                         f"{vk.transcript!r}: check a BabyBear proof with "
                         f"prover_bb.quotient_identity_at_z and bb_kernels.verify_path_bb")
    geometry = vk.geometry
    n = vk.trace_len
    log_n = n.bit_length() - 1
    L = vk.fri_lde_factor
    Q = vk.quotient_degree
    log_full = log_n + (L.bit_length() - 1)
    if [g.name for g in gates] != list(vk.gate_names):
        return False
    try:
        lo = OracleLayout.build(geometry, vk.lookup_params, gates, vk.selector_paths)
    except ValueError:
        return False  # lookups on marker rows, but no lookup-marker gate
    Ct = lo.Ct  # every column under the copy permutation
    lookups = lo.lookups
    wdt, R = lo.width, lo.R
    if vk.num_copy_cols != Ct or vk.num_wit_cols != lo.W:
        return False
    if len(proof.public_inputs) != len(vk.public_input_locations):
        return False
    chunks = lo.chunks
    B = lo.num_columns(Q)
    if len(proof.values_at_z) != B or len(proof.values_at_z_omega) != 2:
        return False
    if len(proof.values_at_0) != lo.num_values_at_0:
        return False

    # ---- transcript replay ------------------------------------------------
    t = make_transcript(vk.transcript)
    t.witness_merkle_tree_cap(vk.setup_merkle_cap)
    t.witness_field_elements(proof.public_inputs)
    t.witness_merkle_tree_cap(proof.witness_cap)
    beta = t.get_ext_challenge()
    gamma = t.get_ext_challenge()
    if lookups:
        lookup_beta = t.get_ext_challenge()
        lookup_gamma = t.get_ext_challenge()
    t.witness_merkle_tree_cap(proof.stage2_cap)
    alpha = t.get_ext_challenge()
    t.witness_merkle_tree_cap(proof.quotient_cap)
    z = t.get_ext_challenge()
    for v in [*proof.values_at_z, *proof.values_at_z_omega, *proof.values_at_0]:
        t.witness_field_elements(v)
    deep_ch = t.get_ext_challenge()
    try:
        schedule = fold_schedule(n, vk.fri_final_degree, vk.fri_folding_schedule)
    except ValueError:
        return False
    num_folds = sum(schedule)
    if len(proof.fri_caps) != len(schedule):
        return False
    fri_challenges = []
    for cap in proof.fri_caps:
        t.witness_merkle_tree_cap(cap)
        fri_challenges.append(t.get_ext_challenge())
    if len(proof.final_fri_monomials) != (n >> num_folds):
        return False
    for c0, c1 in proof.final_fri_monomials:
        t.witness_field_elements([c0, c1])

    # ---- quotient identity at z ------------------------------------------
    vals = [tuple(v) for v in proof.values_at_z]
    Cw, Cs, S = lo.num_wit_rows, lo.num_setup_rows, lo.num_s2_rows
    wit_vals = vals[:Cw]
    setup_vals = vals[Cw : Cw + Cs]
    sigma_vals = setup_vals[:Ct]
    const_vals = setup_vals[Ct : Ct + lo.K]
    table_vals = setup_vals[lo.table_row :]
    s2_vals = vals[Cw + Cs : Cw + Cs + S]
    q_vals = vals[Cw + Cs + S :]
    alpha_pows = _powers_iter(alpha)
    total = ext_f.ZERO_S
    for gid, gate in enumerate(gates):
        if gate.num_terms == 0:
            continue
        path = vk.selector_paths[gid]
        sel = ext_f.ONE_S
        for b, bit in enumerate(path):
            cb = const_vals[b]
            sel = ext_f.mul_s(sel, cb if bit else ext_f.sub_s(ext_f.ONE_S, cb))
        gate_acc = ext_f.ZERO_S
        for inst in range(gate.num_repetitions(geometry)):
            dst = TermsCollector()
            gate.evaluate(
                ExtScalarOps,
                _ZRowView(wit_vals, const_vals, inst * gate.principal_width,
                          lo.wit_col + inst * gate.witness_width, len(path)),
                dst,
            )
            if len(dst.terms) != gate.num_terms:
                return False
            for term in dst.terms:
                gate_acc = ext_f.add_s(gate_acc, ext_f.mul_s(term, next(alpha_pows)))
        total = ext_f.add_s(total, ext_f.mul_s(sel, gate_acc))

    z_at_z = ext_from_pair(s2_vals[0], s2_vals[1])
    z_at_zw = ext_from_pair(tuple(proof.values_at_z_omega[0]),
                            tuple(proof.values_at_z_omega[1]))
    partial_at_z = [ext_from_pair(s2_vals[2 + 2 * j], s2_vals[3 + 2 * j])
                    for j in range(len(chunks) - 1)]
    ks = non_residues_for_copy_permutation(Ct)
    zh_at_z = ext_f.sub_s(ext_f.pow_s(z, n), ext_f.ONE_S)
    l0_at_z = ext_f.mul_s(
        ext_f.mul_s(zh_at_z, (gl.inv(n), 0)), ext_f.inv_s(ext_f.sub_s(z, ext_f.ONE_S))
    )
    term = ext_f.mul_s(l0_at_z, ext_f.sub_s(z_at_z, ext_f.ONE_S))
    total = ext_f.add_s(total, ext_f.mul_s(term, next(alpha_pows)))
    lhs_seq = partial_at_z + [z_at_zw]
    rhs_seq = [z_at_z] + partial_at_z
    for j, chunk in enumerate(chunks):
        num_p = den_p = ext_f.ONE_S
        for col in chunk:
            w = wit_vals[col]
            kx = ext_f.mul_by_base_s(z, ks[col])
            num_p = ext_f.mul_s(num_p, ext_f.add_s(ext_f.add_s(w, ext_f.mul_s(beta, kx)), gamma))
            den_p = ext_f.mul_s(
                den_p, ext_f.add_s(ext_f.add_s(w, ext_f.mul_s(beta, sigma_vals[col])), gamma)
            )
        rel = ext_f.sub_s(ext_f.mul_s(lhs_seq[j], den_p), ext_f.mul_s(rhs_seq[j], num_p))
        total = ext_f.add_s(total, ext_f.mul_s(rel, next(alpha_pows)))
    ab = lo.ab_row  # first A_i row of stage 2
    if lookups:
        # A_i·den_i - sel and B·den_t - M at z, then Σ_i A_i(0) = B(0);
        # sel is 1 in specialized mode and the marker's selector in general
        gpow = ext_f.powers_s(lookup_gamma, wdt + 1)
        tid_at_z = const_vals[lo.tid_const]
        sel_at_z = ext_f.ONE_S
        for b, bit in enumerate(lo.marker_path):
            cb = const_vals[b]
            sel_at_z = ext_f.mul_s(sel_at_z, cb if bit else ext_f.sub_s(ext_f.ONE_S, cb))
        base = lo.lookup_col_base
        for i in range(R):
            a_i = ext_from_pair(s2_vals[ab + 2 * i], s2_vals[ab + 2 * i + 1])
            den = ext_f.add_s(lookup_beta, ext_f.mul_s(gpow[wdt], tid_at_z))
            for j in range(wdt):
                den = ext_f.add_s(den, ext_f.mul_s(gpow[j], wit_vals[base + i * wdt + j]))
            rel = ext_f.sub_s(ext_f.mul_s(a_i, den), sel_at_z)
            total = ext_f.add_s(total, ext_f.mul_s(rel, next(alpha_pows)))
        b_at_z = ext_from_pair(s2_vals[ab + 2 * R], s2_vals[ab + 2 * R + 1])
        den = lookup_beta
        for j in range(wdt + 1):
            den = ext_f.add_s(den, ext_f.mul_s(gpow[j], table_vals[j]))
        rel = ext_f.sub_s(ext_f.mul_s(b_at_z, den), wit_vals[lo.mult_row])
        total = ext_f.add_s(total, ext_f.mul_s(rel, next(alpha_pows)))
        a_sum = ext_f.ZERO_S
        for i in range(R):
            a_sum = ext_f.add_s(a_sum, tuple(proof.values_at_0[i]))
        if a_sum != tuple(proof.values_at_0[R]):
            return False
    t_at_z = ext_f.ZERO_S
    for i in range(Q):
        q_i = ext_from_pair(q_vals[2 * i], q_vals[2 * i + 1])
        t_at_z = ext_f.add_s(t_at_z, ext_f.mul_s(q_i, ext_f.pow_s(z, i * n)))
    if total != ext_f.mul_s(t_at_z, zh_at_z):
        return False

    # ---- PoW + queries ----------------------------------------------------
    if not pow_verify(t, vk.pow_bits, proof.pow_challenge):
        return False
    if len(proof.queries) != vk.num_queries:
        return False
    omega = gl.omega(log_n)
    zw = ext_f.mul_by_base_s(z, omega)
    bs = BitSource(log_full)
    for q in proof.queries:
        idx = bs.get_index(t, log_full)
        for oq, cap, width in (
            (q.witness, proof.witness_cap, Cw),
            (q.stage2, proof.stage2_cap, S),
            (q.quotient, proof.quotient_cap, 2 * Q),
            (q.setup, vk.setup_merkle_cap, Cs),
        ):
            if len(oq.leaf_values) != width:
                return False
            if not verify_proof_over_cap(oq.leaf_values, oq.path, cap, idx):
                return False
        x = gl.mul(gl.MULTIPLICATIVE_GENERATOR,
                   gl.pow_(gl.omega(log_full), _brev(idx, log_full)))
        f_all = [
            (v, 0)
            for v in (list(q.witness.leaf_values) + list(q.setup.leaf_values)
                      + list(q.stage2.leaf_values) + list(q.quotient.leaf_values))
        ]
        inv_xz = ext_f.inv_s(ext_f.sub_s((x, 0), z))
        inv_xzw = ext_f.inv_s(ext_f.sub_s((x, 0), zw))
        h = ext_f.ZERO_S
        ch_iter = _powers_iter(deep_ch)
        for i in range(B):
            diff = ext_f.sub_s(f_all[i], vals[i])
            h = ext_f.add_s(h, ext_f.mul_s(ext_f.mul_s(diff, inv_xz), next(ch_iter)))
        for i in range(2):
            diff = ext_f.sub_s((q.stage2.leaf_values[i], 0), tuple(proof.values_at_z_omega[i]))
            h = ext_f.add_s(h, ext_f.mul_s(ext_f.mul_s(diff, inv_xzw), next(ch_iter)))
        if lookups:
            inv_x = gl.inv(x)
            for i in range(R + 1):
                f_pair = (q.stage2.leaf_values[ab + 2 * i], q.stage2.leaf_values[ab + 2 * i + 1])
                diff = ext_f.sub_s(f_pair, tuple(proof.values_at_0[i]))
                h = ext_f.add_s(h, ext_f.mul_s(ext_f.mul_by_base_s(diff, inv_x), next(ch_iter)))
        for k, (col, row) in enumerate(vk.public_input_locations):
            ch = next(ch_iter)
            diff = gl.sub(q.witness.leaf_values[col], proof.public_inputs[k])
            tb = gl.mul(diff, gl.inv(gl.sub(x, gl.pow_(omega, row))))
            h = ext_f.add_s(h, ext_f.mul_by_base_s(ch, tb))
        if len(q.fri) != len(schedule):
            return False
        leaves = []
        fidx = idx
        for r, (k, oq) in enumerate(zip(schedule, q.fri)):
            block = 1 << k
            leaf_idx = fidx >> k
            if len(oq.leaf_values) != 2 * block:
                return False
            if not verify_proof_over_cap(oq.leaf_values, oq.path, proof.fri_caps[r], leaf_idx):
                return False
            leaves.append([(oq.leaf_values[2 * j], oq.leaf_values[2 * j + 1])
                           for j in range(block)])
            fidx = leaf_idx
        if tuple(leaves[0][idx % (1 << schedule[0])]) != tuple(h):
            return False
        if not fri_verify_queries(schedule, fri_challenges,
                                  [tuple(c) for c in proof.final_fri_monomials],
                                  idx, leaves, log_full):
            return False
    return True
