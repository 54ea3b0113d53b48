"""The BabyBear mini-STARK's verifier (the JAX package's prover/bb_verifier.py).

Host python ints: replays the transcript to re-derive every challenge,
checks the out-of-domain identity Q(z) = Qt(z) + alpha·Qb(z) in GF(p^4),
the final codeword's degree, the proof of work and the query indices, then
walks each query: Merkle paths of the trace, quotient and FRI layers, the
DEEP value at both fold points and the fold chain down to the final
codeword. `check_babybear` returns (ok, reason); `verify_babybear` the bool.
"""

from __future__ import annotations

import torch

from ..field import babybear as bb
from ..field.spec import BABYBEAR
from ..ntt import bb_ntt
from ..transcript import BitSource, Poseidon2BabyBearTranscript
from .bb_kernels import verify_path_bb
from .bb_prover import BBProof
from .pow import blake2s_pow_verify

_W = (0, 1, 0, 0)  # the ext generator w


def _ext(v) -> tuple:
    return tuple(int(c) % bb.P for c in v)


def check_babybear(proof: BBProof):
    cfg = proof.config
    n, L, N = cfg.n, cfg.lde_factor, cfg.domain_len
    log_N = N.bit_length() - 1
    num_folds = cfg.num_folds
    pub = int(proof.pub) % bb.P

    if len(proof.fri_caps) != num_folds - 1:
        return False, "fri cap count"
    if len(proof.final_codeword) != cfg.final_len:
        return False, "final codeword length"
    if len(proof.query_indices) != cfg.num_queries:
        return False, "query count"
    if any(not 0 <= int(i) < N for i in proof.query_indices):
        return False, "query index range"

    t = Poseidon2BabyBearTranscript()
    t.witness_field_elements(cfg.params_list() + [pub])
    t.witness_merkle_tree_cap(proof.witness_cap)
    alpha = t.get_ext_challenge()
    t.witness_merkle_tree_cap(proof.quotient_cap)
    z = t.get_ext_challenge()
    wz, wgz = _ext(proof.evals["wz"]), _ext(proof.evals["wgz"])
    qz = [_ext(e) for e in proof.evals["qz"]]
    t.witness_field_elements([c for e in [wz, wgz] + qz for c in e])
    gammas = [t.get_ext_challenge() for _ in range(6)]
    betas = []
    for r in range(num_folds):
        if r > 0:
            t.witness_merkle_tree_cap(proof.fri_caps[r - 1])
        betas.append(t.get_ext_challenge())
    final = [_ext(e) for e in proof.final_codeword]
    t.witness_field_elements([c for e in final for c in e])
    if not blake2s_pow_verify(t, cfg.pow_bits, proof.pow_nonce):
        return False, "pow"
    bits = BitSource(log_N, challenge_bits=BABYBEAR.challenge_bits)
    idxs = [bits.get_index(t, log_N) for _ in range(cfg.num_queries)]
    if idxs != [int(i) for i in proof.query_indices]:
        return False, "query indices"

    # Q(z) = Qt(z) + alpha·Qb(z)
    g = bb.omega(cfg.log_n)
    gz = bb.ext_scale_s(z, g)
    zn = bb.ext_pow_s(z, n)
    if zn == bb.ONE_S or z == bb.ONE_S:
        return False, "degenerate z"
    c_z = bb.ext_sub_s(wgz, bb.ext_add_s(bb.ext_mul_s(wz, wz),
                                         bb.ext_from_base_s(cfg.square_c)))
    qt_z = bb.ext_mul_s(
        bb.ext_mul_s(c_z, bb.ext_sub_s(z, bb.ext_from_base_s(bb.pow_s(g, n - 1)))),
        bb.ext_inv_s(bb.ext_sub_s(zn, bb.ONE_S)))
    qb_z = bb.ext_mul_s(bb.ext_sub_s(wz, bb.ext_from_base_s(pub)),
                        bb.ext_inv_s(bb.ext_sub_s(z, bb.ONE_S)))
    lhs = bb.ext_add_s(qt_z, bb.ext_mul_s(alpha, qb_z))
    rhs, wk = bb.ZERO_S, bb.ONE_S
    for k in range(4):
        rhs = bb.ext_add_s(rhs, bb.ext_mul_s(qz[k], wk))
        wk = bb.ext_mul_s(wk, _W)
    if lhs != rhs:
        return False, "eval identity"

    # the final codeword over shift^(2^num_folds)·<w_final_len>: its
    # coefficients from final_len / L on must vanish
    final_t = torch.tensor(final, dtype=torch.int64).T.contiguous()
    mono = bb_ntt.coset_descale(bb_ntt.monomial_from_values(final_t),
                                bb.pow_s(cfg.shift, 1 << num_folds))
    if bool(mono[:, cfg.final_len // L :].any()):
        return False, "final degree"

    w_n = bb.omega(log_N)

    def deep_at(j: int, w_j: int, q_j) -> tuple:
        x = bb.ext_from_base_s(bb.mul_s(cfg.shift, bb.pow_s(w_n, j)))
        num = bb.ext_mul_s(gammas[0], bb.ext_sub_s(bb.ext_from_base_s(w_j), wz))
        for k in range(4):
            num = bb.ext_add_s(num, bb.ext_mul_s(
                gammas[2 + k], bb.ext_sub_s(bb.ext_from_base_s(q_j[k]), qz[k])))
        d1 = bb.ext_mul_s(num, bb.ext_inv_s(bb.ext_sub_s(x, z)))
        d2 = bb.ext_mul_s(
            bb.ext_mul_s(gammas[1], bb.ext_sub_s(bb.ext_from_base_s(w_j), wgz)),
            bb.ext_inv_s(bb.ext_sub_s(x, gz)))
        return bb.ext_add_s(d1, d2)

    if len(proof.queries) != cfg.num_queries:
        return False, "opening count"
    for pos, opens in zip(idxs, proof.queries):
        if int(opens["pos"]) != pos:
            return False, "opening position"
        j0 = pos % (N // 2)
        pair = []
        for side, j in enumerate((j0, j0 + N // 2)):
            w_vals, w_path = opens["w"][side]
            if len(w_vals) != 1 or not verify_path_bb(w_vals, w_path, proof.witness_cap, j):
                return False, "witness path"
            q_vals, q_path = opens["q"][side]
            if len(q_vals) != 4 or not verify_path_bb(q_vals, q_path, proof.quotient_cap, j):
                return False, "quotient path"
            pair.append(deep_at(j, int(w_vals[0]), q_vals))
        f0, f1 = pair
        p = j0
        for r in range(num_folds):
            # fold the (p, p + M/2) pair of layer r at x = sh_r·w_M^p
            m_r = N >> r
            x = bb.mul_s(bb.pow_s(cfg.shift, 1 << r),
                         bb.pow_s(bb.omega(m_r.bit_length() - 1), p))
            even = bb.ext_scale_s(bb.ext_add_s(f0, f1), bb.INV2)
            odd = bb.ext_scale_s(bb.ext_sub_s(f0, f1), bb.inv_s(bb.mul_s(2, x)))
            folded = bb.ext_add_s(even, bb.ext_mul_s(betas[r], odd))
            if r + 1 == num_folds:
                if folded != final[p]:
                    return False, "final mismatch"
                break
            m_next = m_r // 2
            leaf_idx = p % (m_next // 2)
            leaf_vals, path = opens["fri"][r]
            if len(leaf_vals) != 8 or not verify_path_bb(leaf_vals, path,
                                                          proof.fri_caps[r], leaf_idx):
                return False, "fri path"
            lo, hi = _ext(leaf_vals[0:4]), _ext(leaf_vals[4:8])
            if folded != (lo if p < m_next // 2 else hi):
                return False, "fold mismatch"
            f0, f1, p = lo, hi, leaf_idx
    return True, "ok"


def verify_babybear(proof: BBProof) -> bool:
    return check_babybear(proof)[0]
