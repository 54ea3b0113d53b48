"""The recursive verifier: a Boojum proof verified inside a circuit, as in
the JAX package's gadgets/recursion/verifier.py (era-boojum
recursive_verifier.rs:380 `RecursiveVerifier::verify`).

It follows the host verifier (prover/verifier.py) step for step: the
transcript replayed, the quotient at z rebuilt by running the inner
circuit's own gate evaluators over `CircuitExtOps`, the copy-permutation
and lookup relations, DEEP, the Merkle paths and the FRI chain; but every
field op is a gadget constraint and every hash a flattened-permutation
sponge. Validity is enforced (no witness satisfies the circuit unless the
proof verifies), not returned; checks of shape are host asserts at
synthesis, as they depend on the VK alone. Column positions come from
prover/layout.py.

Returns (the inner public-input variables, the setup-cap variables) for
the caller to expose.
"""

from __future__ import annotations

from ...cs.gates.base import TermsCollector
from ...cs.gates.simple import ConditionalSwapGate, FmaGate
from ...field import gl
from ...prover.fri import fold_schedule
from ...prover.layout import OracleLayout
from ...prover.setup import non_residues_for_copy_permutation
from ...prover.verifier import _ZRowView
from .. import poseidon2_rf, poseidon_rf
from ..field_like_circuit import CircuitExtOps, CircuitOps
from ..poseidon2_rf import circuit_hash_leaf, circuit_hash_node
from .allocated_proof import AllocatedProof, AllocatedVerificationKey
from .transcript import CircuitBitSource, CircuitTranscript, decompose_challenge_canonical

INV2 = (gl.P + 1) // 2
# the round function each replayable transcript draws with
TRANSCRIPT_PERMUTATIONS = {"poseidon2": poseidon2_rf.circuit_permutation,
                           "poseidon": poseidon_rf.circuit_permutation}


def _ext_from_pair(ops, a, b):
    """The opening of an extension-coefficient polynomial from its two base
    openings: a + b·w (w^2 = 7)."""
    w = (ops.cs.zero_var(), ops.cs.one_var())
    return ops.add(a, ops.mul(b, w))


class _PowIter:
    def __init__(self, ops, base):
        self.ops = ops
        self.base = base
        self.cur = ops.one()

    def __next__(self):
        out = self.cur
        self.cur = self.ops.mul(self.cur, self.base)
        return out


def _selector_at_z(ops, const_vals, path):
    sel = ops.one()
    for b, bit in enumerate(path):
        cb = const_vals[b]
        sel = ops.mul(sel, cb if bit else ops.sub(ops.one(), cb))
    return sel


def _mux_digest(bops: CircuitOps, bits, digests):
    """digests[index] for little-endian index bit variables, by a tree of
    selects."""
    values = list(digests)
    for b in bits:
        assert len(values) % 2 == 0
        values = [[bops.select(b, values[2 * i + 1][e], values[2 * i][e]) for e in range(4)]
                  for i in range(len(values) // 2)]
    assert len(values) == 1
    return values[0]


def _verify_merkle_path(cs, bops, leaf_vars, path, cap, idx_bits):
    """Enforce that leaf_vars open against the cap at the index of idx_bits
    (little-endian), as merkle.py verify_proof_over_cap checks."""
    digest = circuit_hash_leaf(cs, leaf_vars)
    for level, sib in enumerate(path):
        left, right = [], []
        for e in range(4):
            l_e, r_e = ConditionalSwapGate.swap(cs, idx_bits[level], digest[e], sib[e])
            left.append(l_e)
            right.append(r_e)
        digest = circuit_hash_node(cs, left, right)
    cap_bits = idx_bits[len(path):]
    assert len(cap) == 1 << len(cap_bits)
    expected = _mux_digest(bops, cap_bits, cap)
    for e in range(4):
        bops.enforce_equal(digest[e], expected[e])


def _point_from_bits(bops: CircuitOps, bits, omega: int, shift: int):
    """shift·ω^nat where nat's bit (m - 1 - j) is index bit j (the index is
    bit-reversed): shift·Π_j select(bit_j, ω^(2^(m-1-j)), 1)."""
    m = len(bits)
    acc = bops.constant(shift)
    for j, bit in enumerate(bits):
        factor = bops.select(bit, bops.constant(gl.pow_(omega, 1 << (m - 1 - j))), bops.one())
        acc = bops.mul(acc, factor)
    return acc


def recursive_verify(cs, vk, proof, gates):
    """Synthesize into `cs` the verification of `proof` (a host Proof)
    against `vk`; `gates`: the inner circuit's gates (the verifier is built
    from the same gate configuration, recursive_verifier_builder.rs)."""
    ap = AllocatedProof(cs, proof)
    avk = AllocatedVerificationKey(cs, vk)
    ops = CircuitExtOps(cs)
    bops = CircuitOps(cs)

    geometry = vk.geometry
    n = vk.trace_len
    log_n = n.bit_length() - 1
    L = vk.fri_lde_factor
    Q = vk.quotient_degree
    log_full = log_n + (L.bit_length() - 1)
    assert vk.transcript in TRANSCRIPT_PERMUTATIONS, (
        "the verifier in a circuit replays the algebraic transcripts only (Poseidon2 or "
        "legacy Poseidon), as the reference's recursion configurations do")
    lo = OracleLayout.build(geometry, vk.lookup_params, gates, vk.selector_paths)
    Ct, W, K, R, wdt = lo.Ct, lo.W, lo.K, lo.R, lo.width
    lookups = lo.lookups
    assert vk.num_copy_cols == Ct and vk.num_wit_cols == W
    assert [g.name for g in gates] == list(vk.gate_names)
    assert len(proof.public_inputs) == len(vk.public_input_locations)
    Cw, Cs, S = lo.num_wit_rows, lo.num_setup_rows, lo.num_s2_rows
    B = lo.num_columns(Q)
    assert len(proof.values_at_z) == B and len(proof.values_at_z_omega) == 2
    assert len(proof.values_at_0) == lo.num_values_at_0

    # ---- transcript replay ------------------------------------------------
    t = CircuitTranscript(cs, permutation=TRANSCRIPT_PERMUTATIONS[vk.transcript])
    t.witness_merkle_tree_cap(avk.setup_merkle_cap)
    t.witness_field_elements(ap.public_inputs)
    t.witness_merkle_tree_cap(ap.witness_cap)
    beta = t.get_ext_challenge()
    gamma = t.get_ext_challenge()
    if lookups:
        lookup_beta = t.get_ext_challenge()
        lookup_gamma = t.get_ext_challenge()
    t.witness_merkle_tree_cap(ap.stage2_cap)
    alpha = t.get_ext_challenge()
    t.witness_merkle_tree_cap(ap.quotient_cap)
    z_chal = t.get_ext_challenge()
    for v in [*ap.values_at_z, *ap.values_at_z_omega, *ap.values_at_0]:
        t.witness_field_elements(list(v))
    deep_ch = t.get_ext_challenge()
    schedule = fold_schedule(n, vk.fri_final_degree, vk.fri_folding_schedule)
    num_folds = sum(schedule)
    assert len(proof.fri_caps) == len(schedule)
    fri_challenges = []
    for cap in ap.fri_caps:
        t.witness_merkle_tree_cap(cap)
        fri_challenges.append(t.get_ext_challenge())
    assert len(proof.final_fri_monomials) == (n >> num_folds)
    for c0, c1 in ap.final_fri_monomials:
        t.witness_field_elements([c0, c1])

    # ---- split openings ---------------------------------------------------
    vals = ap.values_at_z
    wit_vals = vals[:Cw]
    setup_vals = vals[Cw : Cw + Cs]
    sigma_vals = setup_vals[:Ct]
    const_vals = setup_vals[Ct : Ct + K]
    table_vals = setup_vals[lo.table_row:]
    s2_vals = vals[Cw + Cs : Cw + Cs + S]
    q_vals = vals[Cw + Cs + S:]

    # ---- quotient identity at z ------------------------------------------
    alpha_pows = _PowIter(ops, alpha)
    total = ops.zero()
    for gid, gate in enumerate(gates):
        if gate.num_terms == 0:
            continue
        path = vk.selector_paths[gid]
        sel = _selector_at_z(ops, const_vals, path)
        gate_acc = ops.zero()
        for inst in range(gate.num_repetitions(geometry)):
            row = _ZRowView(wit_vals, const_vals, inst * gate.principal_width,
                            lo.wit_col + inst * gate.witness_width, len(path))
            dst = TermsCollector()
            gate.evaluate(ops, row, dst)
            assert len(dst.terms) == gate.num_terms
            for term in dst.terms:
                gate_acc = ops.add(gate_acc, ops.mul(term, next(alpha_pows)))
        total = ops.add(total, ops.mul(sel, gate_acc))

    # the copy permutation at z
    chunks = lo.chunks
    z_at_z = _ext_from_pair(ops, s2_vals[0], s2_vals[1])
    z_at_zw = _ext_from_pair(ops, ap.values_at_z_omega[0], ap.values_at_z_omega[1])
    partial_at_z = [_ext_from_pair(ops, s2_vals[2 + 2 * j], s2_vals[3 + 2 * j])
                    for j in range(len(chunks) - 1)]
    non_residues = non_residues_for_copy_permutation(Ct)
    z_pow_n = ops.pow(z_chal, n)
    zh_at_z = ops.sub(z_pow_n, ops.one())
    l0_at_z = ops.mul(ops.mul_by_base_constant(zh_at_z, gl.inv(n)),
                      ops.inv(ops.sub(z_chal, ops.one())))
    term = ops.mul(l0_at_z, ops.sub(z_at_z, ops.one()))
    total = ops.add(total, ops.mul(term, next(alpha_pows)))
    lhs_seq = partial_at_z + [z_at_zw]
    rhs_seq = [z_at_z] + partial_at_z
    for j, chunk in enumerate(chunks):
        num_p = ops.one()
        den_p = ops.one()
        for col in chunk:
            w = wit_vals[col]
            kx = ops.mul_by_base_constant(z_chal, non_residues[col])
            num = ops.add(ops.add(w, ops.mul(beta, kx)), gamma)
            den = ops.add(ops.add(w, ops.mul(beta, sigma_vals[col])), gamma)
            num_p = ops.mul(num_p, num)
            den_p = ops.mul(den_p, den)
        rel = ops.sub(ops.mul(lhs_seq[j], den_p), ops.mul(rhs_seq[j], num_p))
        total = ops.add(total, ops.mul(rel, next(alpha_pows)))

    # the lookup relations at z and the sum check at 0, in either placement
    # (lookup_placement.rs:21): in general mode the table id is the marker
    # row's constant and each A relation is gated by the marker's selector
    ab = lo.ab_row
    if lookups:
        gpow = [ops.one()]
        for _ in range(wdt + 1):
            gpow.append(ops.mul(gpow[-1], lookup_gamma))
        tid_at_z = const_vals[lo.tid_const]
        a_numerator = (_selector_at_z(ops, const_vals, lo.marker_path) if not lo.specialized
                       else ops.one())
        for i in range(R):
            a_i = _ext_from_pair(ops, s2_vals[ab + 2 * i], s2_vals[ab + 2 * i + 1])
            den = lookup_beta
            for j in range(wdt):
                den = ops.add(den, ops.mul(gpow[j], wit_vals[lo.lookup_col_base + i * wdt + j]))
            den = ops.add(den, ops.mul(gpow[wdt], tid_at_z))
            rel = ops.sub(ops.mul(a_i, den), a_numerator)
            total = ops.add(total, ops.mul(rel, next(alpha_pows)))
        b_at_z = _ext_from_pair(ops, s2_vals[ab + 2 * R], s2_vals[ab + 2 * R + 1])
        den = lookup_beta
        for j in range(wdt + 1):
            den = ops.add(den, ops.mul(gpow[j], table_vals[j]))
        rel = ops.sub(ops.mul(b_at_z, den), wit_vals[lo.mult_row])
        total = ops.add(total, ops.mul(rel, next(alpha_pows)))
        a_sum = ops.zero()
        for i in range(R):
            a_sum = ops.add(a_sum, ap.values_at_0[i])
        ops.enforce_equal(a_sum, ap.values_at_0[R])

    # T(z)·Z_H(z) = total
    t_at_z = ops.zero()
    z_pows = _PowIter(ops, z_pow_n)
    for i in range(Q):
        q_i = _ext_from_pair(ops, q_vals[2 * i], q_vals[2 * i + 1])
        t_at_z = ops.add(t_at_z, ops.mul(q_i, next(z_pows)))
    ops.enforce_equal(total, ops.mul(t_at_z, zh_at_z))

    # ---- PoW --------------------------------------------------------------
    if vk.pow_bits > 0:
        seed = t.get_multiple_challenges(4)
        h = circuit_hash_leaf(cs, seed + [ap.pow_challenge])
        h_bits = decompose_challenge_canonical(cs, h[0])
        for b in h_bits[: vk.pow_bits]:
            FmaGate.enforce_fma(cs, cs.one_var(), b, cs.zero_var(), cs.zero_var(), 1, 0)
        t.witness_field_elements([ap.pow_challenge])

    # ---- queries ----------------------------------------------------------
    assert len(proof.queries) == vk.num_queries
    omega = gl.omega(log_n)
    zw = ops.mul_by_base_constant(z_chal, omega)
    bs = CircuitBitSource(cs, log_full)
    omega_full = gl.omega(log_full)
    g = gl.MULTIPLICATIVE_GENERATOR
    for q in ap.queries:
        idx_bits = bs.get_index_bits(t, log_full)
        for oq, cap in ((q.witness, ap.witness_cap), (q.stage2, ap.stage2_cap),
                        (q.quotient, ap.quotient_cap), (q.setup, avk.setup_merkle_cap)):
            _verify_merkle_path(cs, bops, oq.leaf_values, oq.path, cap, idx_bits)
        assert len(q.witness.leaf_values) == Cw
        assert len(q.setup.leaf_values) == Cs
        assert len(q.stage2.leaf_values) == S
        assert len(q.quotient.leaf_values) == 2 * Q

        # x = g·ω^brev(idx)
        x = _point_from_bits(bops, idx_bits, omega_full, g)
        f_all = [ops.from_base_var(v) for v in (q.witness.leaf_values + q.setup.leaf_values
                                                 + q.stage2.leaf_values
                                                 + q.quotient.leaf_values)]
        inv_xz = ops.inv(ops.sub(ops.from_base_var(x), z_chal))
        inv_xzw = ops.inv(ops.sub(ops.from_base_var(x), zw))
        h_val = ops.zero()
        ch_iter = _PowIter(ops, deep_ch)
        for i in range(B):
            diff = ops.sub(f_all[i], vals[i])
            h_val = ops.add(h_val, ops.mul(ops.mul(diff, inv_xz), next(ch_iter)))
        for i in range(2):
            diff = ops.sub(ops.from_base_var(q.stage2.leaf_values[i]), ap.values_at_z_omega[i])
            h_val = ops.add(h_val, ops.mul(ops.mul(diff, inv_xzw), next(ch_iter)))
        if lookups:
            inv_x = bops.inv(x)
            for i in range(R + 1):
                ch = next(ch_iter)
                f_pair = (q.stage2.leaf_values[ab + 2 * i], q.stage2.leaf_values[ab + 2 * i + 1])
                diff = ops.sub(f_pair, ap.values_at_0[i])
                h_val = ops.add(h_val, ops.mul(ops.mul_by_base(diff, inv_x), ch))
        for k_pi, (col, row) in enumerate(vk.public_input_locations):
            ch = next(ch_iter)
            diff = bops.sub(q.witness.leaf_values[col], ap.public_inputs[k_pi])
            denom = bops.inv(FmaGate.fma(cs, bops.one(), x,
                                         cs.allocate_constant(gl.pow_(omega, row)), 1,
                                         gl.P - 1))
            h_val = ops.add(h_val, ops.mul_by_base(ch, bops.mul(diff, denom)))

        # the FRI chain, oracles grouped by the schedule: a leaf holds a
        # whole 2^k fold subtree, folded with ch, ch^2, ... (fri/mod.rs:362)
        assert len(q.fri) == len(schedule)
        cur_expected = None
        off = 0
        for r, (k_r, oq) in enumerate(zip(schedule, q.fri)):
            block = 1 << k_r
            assert len(oq.leaf_values) == 2 * block
            _verify_merkle_path(cs, bops, oq.leaf_values, oq.path, ap.fri_caps[r],
                                idx_bits[off + k_r:])
            points = [(oq.leaf_values[2 * j], oq.leaf_values[2 * j + 1]) for j in range(block)]
            # the value this query follows: the points muxed by the in-block bits
            sel_vals = list(points)
            for b in idx_bits[off : off + k_r]:
                sel_vals = [ops.select(b, sel_vals[2 * i + 1], sel_vals[2 * i])
                            for i in range(len(sel_vals) // 2)]
            ops.enforce_equal(sel_vals[0], h_val if cur_expected is None else cur_expected)
            dbits = idx_bits[off + k_r : log_full]
            fold_vals = points
            ch = fri_challenges[r]
            for j in range(k_r):
                fr = off + j
                log_nr = log_full - fr
                omega_r = gl.pow_(omega_full, 1 << fr)
                shift_r = gl.pow_(g, 1 << fr)
                # the dbits product does not depend on m: made once a fold,
                # then scaled by m's host constant
                base_point = _point_from_bits(bops, dbits, omega_r, 1)
                nxt = []
                for m in range(len(fold_vals) // 2):
                    # the even element's index: low bit 0, m's bits, the
                    # leaf index's bits
                    static_nat = sum(1 << (log_nr - 2 - tb) for tb in range(k_r - j - 1)
                                     if (m >> tb) & 1)
                    shift_eff = gl.mul(shift_r, gl.pow_(omega_r, static_nat))
                    x_r = bops.mul(base_point, bops.constant(shift_eff))
                    even, odd = fold_vals[2 * m], fold_vals[2 * m + 1]
                    s = ops.add(even, odd)
                    dox = ops.mul_by_base(ops.sub(even, odd), bops.inv(x_r))
                    nxt.append(ops.mul_by_base_constant(ops.add(s, ops.mul(dox, ch)), INV2))
                fold_vals = nxt
                ch = ops.mul(ch, ch)
            cur_expected = fold_vals[0]
            off += k_r

        # the final monomials at the fully folded point
        log_fin = log_full - num_folds
        x_fin = _point_from_bits(bops, idx_bits[num_folds : num_folds + log_fin],
                                 gl.omega(log_fin), gl.pow_(g, 1 << num_folds))
        acc = ops.zero()
        xp = ops.one()
        for c in ap.final_fri_monomials:
            acc = ops.add(acc, ops.mul(c, xp))
            xp = ops.mul_by_base(xp, x_fin)
        ops.enforce_equal(acc, cur_expected)

    return ap.public_inputs, avk.setup_merkle_cap
