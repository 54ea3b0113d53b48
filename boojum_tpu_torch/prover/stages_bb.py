"""The BabyBear prover's stage math in GF(p^4): stage 2 (copy-permutation
grand product and partial products, the lookup polynomials A_i and B), the
fused quotient sweep and the DEEP codeword.

The JAX package's prover/stages_bb.py writes each computation once over a
`lib` of jnp ops and once more over numpy; here one tensor version runs on
either device. It is plain PyTorch: the JAX package runs these stages as
XLA, not as Pallas kernels. Terms, and so alpha and DEEP challenge powers,
come in the JAX package's order: gates, copy permutation, lookups.
Arithmetic is exact mod p, so sums may be taken in any order.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..cs.field_like import BBTensorOps
from ..cs.gates.base import TermsCollector
from ..field import babybear as bb
from .bb_kernels import base_minus_ext, domain_xs_bb

I64 = torch.int64


def _num_den(wcol, scol, kx, beta, gamma):
    """The copy-permutation rational's numerator w + beta·k·x + gamma and
    denominator w + beta·sigma + gamma, as (4, ...) ext tensors."""
    num = bb.ext_add(bb.ext_scale(beta, kx), gamma)
    den = bb.ext_add(bb.ext_scale(beta, scol), gamma)
    num[0] = bb.add(num[0], wcol)
    den[0] = bb.add(den[0], wcol)
    return num, den


def _chunk_products(copy_v, sigma_v, ks, xs, beta, gamma, chunk):
    num_p = den_p = None
    for col in chunk:
        num, den = _num_den(copy_v[col], sigma_v[col], bb.mul(xs, int(ks[col])), beta, gamma)
        num_p = num if num_p is None else bb.ext_mul(num_p, num)
        den_p = den if den_p is None else bb.ext_mul(den_p, den)
    return num_p, den_p


def stage2_z_partials(copy_vals, sigma_vals, ks, xs, beta, gamma, chunks) -> torch.Tensor:
    """(1 + num_partials, 4, n): z over H (z(w^0) = 1, the exclusive prefix
    product of the row ratio), then the cumulative chunk partials."""
    copy_v, sigma_v, xs = copy_vals.to(I64), sigma_vals.to(I64), xs.to(I64)
    prods = [_chunk_products(copy_v, sigma_v, ks, xs, beta, gamma, c) for c in chunks]
    den_inv = bb.ext_inv(torch.stack([d for _n, d in prods], dim=1))  # (4, K, n)
    ratios = [bb.ext_mul(num, den_inv[:, j]) for j, (num, _d) in enumerate(prods)]
    full = ratios[0]
    for r in ratios[1:]:
        full = bb.ext_mul(full, r)
    incl = bb.ext_prefix_product(full)
    z = torch.zeros_like(incl)
    z[0, 0] = 1
    z[:, 1:] = incl[:, :-1]
    rows = [z]
    for r in ratios[:-1]:
        rows.append(bb.ext_mul(rows[-1], r))
    return torch.stack(rows).to(bb.DTYPE)


def _aggregate(cols, tid_col, gpow, beta):
    """beta + sum_j gamma^j·col_j (+ gamma^w·table_id) as a (4, n) tensor."""
    seq = list(cols) + ([tid_col] if tid_col is not None else [])
    acc = None
    for j, col in enumerate(seq):
        t = bb.ext_scale(gpow[j], col)
        acc = t if acc is None else bb.ext_add(acc, t)
    return bb.ext_add(acc, beta)


def lookup_polys(lookup_cols, tid_col, table_cols, mults, lkb, lkg, R: int, width: int
                 ) -> torch.Tensor:
    """(R + 1, 4, n): A_i = 1/(lookup denominator i), B = m/(table
    denominator), specialized lookup columns."""
    gpow = bb.ext_powers_s(lkg, width + 1)
    lookup_cols, tid_col, table_cols = lookup_cols.to(I64), tid_col.to(I64), table_cols.to(I64)
    dens = [_aggregate(lookup_cols[i * width : (i + 1) * width], tid_col, gpow, lkb)
            for i in range(R)]
    dens.append(_aggregate(table_cols[:width], table_cols[width], gpow, lkb))
    inv = bb.ext_inv(torch.stack(dens, dim=1))  # (4, R + 1, n)
    rows = [inv[:, i] for i in range(R)] + [bb.mul(inv[:, R], mults.to(I64))]
    return torch.stack(rows).to(bb.DTYPE)


class _RowView:
    """A gate instance's cells over the sweep's column stacks."""

    def __init__(self, copy_v, wit_v, const_v, vo, wo, ko):
        self._c, self._w, self._k = copy_v, wit_v, const_v
        self._vo, self._wo, self._ko = vo, wo, ko

    def v(self, i):
        return self._c[self._vo + i]

    def w(self, i):
        return self._w[self._wo + i]

    def c(self, i):
        return self._k[self._ko + i]


def _selector(const_v, path):
    sel = None
    for b, bit in enumerate(path):
        f = const_v[b] if bit else bb.sub(1, const_v[b])
        sel = f if sel is None else bb.mul(sel, f)
    return sel


class SweepContext:
    """What the quotient sweep needs of the circuit: gates, selector
    paths, geometry, the oracle widths and the copy-permutation chunks."""

    def __init__(self, assembly, selector_paths, non_residues, chunks):
        self.gates = list(assembly.gates)
        self.selector_paths = [tuple(p) for p in selector_paths]
        self.geometry = assembly.geometry
        self.non_residues = [int(k) for k in non_residues]
        self.chunks = [tuple(c) for c in chunks]
        self.lookups = assembly.lookups_enabled
        self.R = assembly.num_lookup_subargs
        self.width = assembly.lookup_params.width if self.lookups else 0
        self.Cg = assembly.num_copy_cols
        self.Ct = self.Cg + assembly.num_lookup_cols
        self.W = assembly.num_wit_cols
        self.Kc = self.geometry.num_constant_columns + (1 if self.lookups else 0)
        self.num_partials = len(self.chunks) - 1
        self.num_gate_terms = sum(g.num_repetitions(self.geometry) * g.num_terms
                                  for g in self.gates if g.num_terms)
        self.num_alpha = (self.num_gate_terms + 1 + len(self.chunks)
                          + ((self.R + 1) if self.lookups else 0))


def sweep_terms(ctx: SweepContext, wit_v, setup_v, s2_v, zs_v, xs, l0, zh_inv, apows,
                beta, gamma, lkb, lkg) -> torch.Tensor:
    """The quotient T = (sum_t alpha^t·term_t) / Z_H over a slice of the
    rate-Q domain, (4, m). `apows` holds the ext powers of alpha as host
    4-tuples, one per term."""
    wit_v, setup_v, s2_v, zs_v = (t.to(I64) for t in (wit_v, setup_v, s2_v, zs_v))
    xs, l0, zh_inv = xs.to(I64), l0.to(I64), zh_inv.to(I64)
    Ct, W, Kc = ctx.Ct, ctx.W, ctx.Kc
    ap = iter(apows)
    copy_v = wit_v[:Ct]
    gate_wit_v = wit_v[Ct : Ct + W]
    sigma_v, const_v, table_v = setup_v[:Ct], setup_v[Ct : Ct + Kc], setup_v[Ct + Kc :]
    z_v = s2_v[0:4]
    partial_v = [s2_v[4 + 4 * j : 8 + 4 * j] for j in range(ctx.num_partials)]
    acc = None

    def plus(a, t):
        return t if a is None else bb.ext_add(a, t)

    for gid, gate in enumerate(ctx.gates):
        if gate.num_terms == 0:
            continue
        path = ctx.selector_paths[gid]
        gate_acc = None
        for inst in range(gate.num_repetitions(ctx.geometry)):
            row = _RowView(copy_v[: ctx.Cg], gate_wit_v, const_v, inst * gate.principal_width,
                           inst * gate.witness_width, len(path))
            dst = TermsCollector()
            gate.evaluate(BBTensorOps, row, dst)
            if len(dst.terms) != gate.num_terms:
                raise AssertionError(f"gate {gate.name}: {len(dst.terms)} terms")
            for term in dst.terms:
                gate_acc = plus(gate_acc, bb.ext_scale(next(ap), term))
        sel = _selector(const_v, path)
        if sel is not None:
            gate_acc = bb.ext_scale(gate_acc, sel)
        acc = plus(acc, gate_acc)
    # copy permutation: L0·(z - 1), then each chunk's relation
    zm1 = z_v.clone()
    zm1[0] = bb.sub(zm1[0], 1)
    acc = plus(acc, bb.ext_mul(bb.ext_scale(zm1, l0), next(ap)))
    lhs = partial_v + [zs_v]
    rhs = [z_v] + partial_v
    for j, chunk in enumerate(ctx.chunks):
        num_p, den_p = _chunk_products(copy_v, sigma_v, ctx.non_residues, xs, beta, gamma,
                                       chunk)
        term = bb.ext_sub(bb.ext_mul(lhs[j], den_p), bb.ext_mul(rhs[j], num_p))
        acc = plus(acc, bb.ext_mul(term, next(ap)))
    if ctx.lookups:
        R, w = ctx.R, ctx.width
        ab = 4 + 4 * ctx.num_partials
        gpow = bb.ext_powers_s(lkg, w + 1)
        for i in range(R):
            cols = copy_v[ctx.Cg + i * w : ctx.Cg + (i + 1) * w]
            term = bb.ext_mul(s2_v[ab + 4 * i : ab + 4 * i + 4],
                              _aggregate(cols, const_v[Kc - 1], gpow, lkb))
            term[0] = bb.sub(term[0], 1)
            acc = plus(acc, bb.ext_mul(term, next(ap)))
        term = bb.ext_mul(s2_v[ab + 4 * R : ab + 4 * R + 4],
                          _aggregate(table_v[:w], table_v[w], gpow, lkb))
        term[0] = bb.sub(term[0], wit_v[Ct + W])
        acc = plus(acc, bb.ext_mul(term, next(ap)))
    if next(ap, None) is not None:
        raise AssertionError("alpha powers left over: the term count is wrong")
    return bb.ext_scale(acc, zh_inv).to(bb.DTYPE)


@lru_cache(maxsize=4)
def l0_lde_bb(log_n: int, rate: int, shift: int, device: str) -> torch.Tensor:
    """L_0(x) = (x^n - 1)/(n·(x - 1)) over shift·<w_{n·rate}>."""
    n = 1 << log_n
    sh_n = bb.pow_s(shift % bb.P, n)
    wl = bb.omega(rate.bit_length() - 1)
    zh = torch.tensor([bb.sub_s(bb.mul_s(sh_n, bb.pow_s(wl, r)), 1) for r in range(rate)],
                      dtype=I64, device=device).repeat(n)
    xm1_inv = bb.inv(bb.sub(domain_xs_bb(log_n, rate, shift, device), 1))
    return bb.mul(bb.mul(zh, bb.inv_s(n)), xm1_inv).to(bb.DTYPE)


def deep_codeword(oracles, zw_cols, lk_cols, pi_cols, xs, z, zw, ch, at_z, y_zw, y_lk,
                  pi_vals, pi_inv) -> torch.Tensor:
    """The DEEP codeword (4, N), challenge powers `ch` (host 4-tuples) in
    the JAX package's order: every committed column at z (the oracles in
    order; `at_z` = sum_i ch_i·f_i(z)), the z polynomial's 4 base columns
    at z·omega, each lookup polynomial A_i, B at 0 (an ext value from its
    4 base columns), the public inputs at their rows."""
    acc = torch.zeros((4, xs.shape[0]), dtype=I64, device=xs.device)
    t = 0
    for oracle in oracles:
        for col in oracle:
            c = col.to(I64)
            for k in range(4):
                acc[k] += (c * ch[t][k]) % bb.P
            t += 1
    num = torch.stack([bb.sub(acc[k] % bb.P, at_z[k]) for k in range(4)])
    h = bb.ext_mul(num, bb.ext_inv(base_minus_ext(xs.to(I64), z)))
    inv_xzw = bb.ext_inv(base_minus_ext(xs.to(I64), zw))
    for i in range(4):
        num_i = base_minus_ext(zw_cols[i].to(I64), y_zw[i])
        h = bb.ext_add(h, bb.ext_mul(bb.ext_mul(num_i, inv_xzw), ch[t]))
        t += 1
    if len(y_lk):
        inv_x = bb.inv(xs.to(I64))
        for i, y in enumerate(y_lk):
            num_i = bb.ext_sub(lk_cols[4 * i : 4 * i + 4].to(I64), y)
            h = bb.ext_add(h, bb.ext_mul(bb.ext_scale(num_i, inv_x), ch[t]))
            t += 1
    for k_pi, value in enumerate(pi_vals):
        num_b = bb.mul(bb.sub(pi_cols[k_pi].to(I64), value), pi_inv[k_pi])
        h = bb.ext_add(h, bb.ext_scale(ch[t], num_b))
        t += 1
    return h.to(bb.DTYPE)
