"""The per-coset quotient sweep (kernel B6, csrc/quotient_sweep.cu).

Replaces boojum_tpu/prover/pallas_sweep.py build_coset_terms (gate,
copy-permutation and specialized lookup parts) and its XLA twin prover.py
_u64_sweep_core. For each row of one quotient coset it sums, with alpha^t
weights in GF(p^2):
- the gate terms of every instance of every gate, masked by the gate's
  selector-path product over the constant columns;
- L0·(z - 1) and, per chunk of copy columns, lhs·prod(den) - rhs·prod(num)
  with num = w + beta·k·x + gamma, den = w + beta·sigma + gamma;
- with lookups, per sub-argument i: A_i·(Σ_j γ'^j·w_{i,j} + γ'^w·tid + β') - 1,
  and for the table: B·(Σ_j γ'^j·t_j + γ'^w·t_id + β') - M;
then multiplies by 1/Z_H. Terms take alpha powers in the JAX package's
order: every gate term first (gate order, instance, term), then the
copy-permutation terms, then the lookup sub-arguments and B.

Gates reach the kernel as data: each gate's captured op program
(cs/gate_capture.py) is encoded into an int32 table that the kernel and the
plain version below both interpret, so the CPU tests check the encoding.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels as K
from ..cs.gate_capture import LOAD_KINDS, OPCODES, capture_gate_program
from ..field import extension as ext_f
from ..field import gl
from ..field import goldilocks as gf

MAX_SLOTS = 32  # csrc/quotient_sweep.cu kMaxSlots


def chunk_columns(num_cols: int, max_degree: int):
    """Copy columns in contiguous chunks of at most max_degree columns."""
    w = max(1, max_degree)
    return [list(range(i, min(i + w, num_cols))) for i in range(0, num_cols, w)]


def chunk_num_den(copy_vals, sigma_vals, non_residues, xs, beta, gamma, chunks):
    """Per chunk of copy columns, the products of num = w + beta·k·x + gamma
    and den = w + beta·sigma + gamma, each a (num_chunks, n) ext pair."""
    nums, dens = [], []
    for chunk in chunks:
        num_p = den_p = None
        for col in chunk:
            w = copy_vals[col]
            kx = gf.mul(xs, int(non_residues[col]))
            num = (gf.add(gf.add(w, gf.mul(kx, beta[0])), gamma[0]),
                   gf.add(gf.mul(kx, beta[1]), gamma[1]))
            s = sigma_vals[col]
            den = (gf.add(gf.add(w, gf.mul(s, beta[0])), gamma[0]),
                   gf.add(gf.mul(s, beta[1]), gamma[1]))
            num_p = num if num_p is None else ext_f.mul(num_p, num)
            den_p = den if den_p is None else ext_f.mul(den_p, den)
        nums.append(num_p)
        dens.append(den_p)
    stack = lambda ps, i: torch.stack([p[i] for p in ps])  # noqa: E731
    return (stack(nums, 0), stack(nums, 1)), (stack(dens, 0), stack(dens, 1))


def aggregate_lookup_columns(cols, table_id_col, gpow, beta):
    """Σ_j γ^j·col_j (+ γ^w·table_id) + β over base columns, an ext pair:
    the log-derivative denominator before inversion. gpow: host ext
    scalars [1, γ, γ², ...]; beta: a host ext scalar."""
    acc0 = torch.full_like(cols[0], gf.as_i64(beta[0]))
    acc1 = torch.full_like(cols[0], gf.as_i64(beta[1]))
    seq = list(cols) + ([table_id_col] if table_id_col is not None else [])
    for j, col in enumerate(seq):
        acc0 = gf.add(acc0, gf.mul(col, gpow[j][0]))
        acc1 = gf.add(acc1, gf.mul(col, gpow[j][1]))
    return acc0, acc1


def num_gate_terms(gates, geometry) -> int:
    return sum(g.num_repetitions(geometry) * g.num_terms for g in gates if g.num_terms)


def encode_gate_programs(gates, selector_paths, geometry):
    """(int32 program table, uint64 constant values) for every gate with
    quotient terms, in gate order (layout in csrc/quotient_sweep.cu).
    Every cell a program loads lies inside the geometry's copy and constant
    columns, which the kernel relies on. Raises on a gate that loads witness
    columns: they are not ported."""
    num_consts = geometry.num_constant_columns
    prog = [0]
    kvals = []
    for gid, gate in enumerate(gates):
        if not gate.num_terms:
            continue
        p = capture_gate_program(gate)
        if p.num_slots > MAX_SLOTS:
            raise ValueError(f"gate {gate.name}: {p.num_slots} slots > {MAX_SLOTS}")
        if len(p.terms) != gate.num_terms:
            raise ValueError(f"gate {gate.name}: term count mismatch")
        if any(kind == "w" for _slot, kind, _idx in p.loads):
            raise NotImplementedError(
                f"gate {gate.name} loads witness columns, which are not ported yet"
            )
        path = selector_paths[gid]
        reps, pw = gate.num_repetitions(geometry), gate.principal_width
        for _slot, kind, idx in p.loads:
            limit = pw if kind == "v" else num_consts - len(path)
            if not 0 <= idx < limit:
                raise ValueError(f"gate {gate.name}: {kind} load {idx} outside {limit}")
        if reps * pw > geometry.num_columns_under_copy_permutation or len(path) > num_consts:
            raise ValueError(f"gate {gate.name} does not fit the geometry")
        prog[0] += 1
        prog += [len(path), *path]
        prog += [reps, pw, len(path), p.num_slots]
        prog.append(len(p.loads))
        for slot, kind, idx in p.loads:
            prog += [slot, LOAD_KINDS[kind], idx]
        prog.append(len(p.consts))
        for slot, value in p.consts:
            prog += [slot, len(kvals)]
            kvals.append(value)
        prog.append(len(p.ops))
        for op, dst, a, b in p.ops:
            prog += [OPCODES[op], dst, a, b]
        prog.append(len(p.terms))
        prog += p.terms
    return np.array(prog, dtype=np.int32), np.array(kvals, dtype=np.uint64)


class SweepPlan:
    """The structure of one circuit's sweep: program tables on a device and
    the counts the kernel needs.

    Operand layout: witness rows [general copy (Cg) | lookup copy | M];
    setup rows [sigma (Ct) | constants (num_consts, the table id last) |
    table columns (width + 1)]; stage-2 rows [z | partials | A_i | B]. The
    lookup rows exist only when `lookup_params` is enabled."""

    def __init__(self, gates, selector_paths, geometry, num_copy_cols, device,
                 lookup_params=None):
        prog, kvals = encode_gate_programs(gates, selector_paths, geometry)
        self.prog_np = prog
        self.kvals_np = kvals
        self.prog = torch.from_numpy(prog).to(device)
        self.kvals = gf.from_numpy(kvals if kvals.size else np.zeros(1, np.uint64),
                                   device)
        lookups = lookup_params is not None and lookup_params.is_enabled
        self.Cg = geometry.num_columns_under_copy_permutation
        self.Ct = num_copy_cols
        self.R = lookup_params.num_repetitions if lookups else 0
        self.width = lookup_params.width if lookups else 0
        if self.Ct != self.Cg + self.R * self.width:
            raise ValueError(f"{self.Ct} copy columns do not fit {self.Cg} general "
                             f"columns and {self.R}x{self.width} lookup columns")
        self.num_consts = geometry.num_constant_columns + (1 if lookups else 0)
        self.num_setup_cols = (self.Ct + self.num_consts
                               + (self.width + 1 if lookups else 0))
        self.num_wit_rows = self.Ct + (1 if lookups else 0)
        self.chunk_deg = max(1, geometry.max_allowed_constraint_degree)
        self.num_chunks = len(chunk_columns(num_copy_cols, self.chunk_deg))
        self.num_s2_rows = 2 * self.num_chunks + (2 * (self.R + 1) if lookups else 0)
        self.num_gate_terms = num_gate_terms(gates, geometry)
        self.num_alpha = (self.num_gate_terms + 1 + self.num_chunks
                          + (self.R + 1 if lookups else 0))
        self.table_len = (4 + self.Ct + 2 * self.num_alpha
                          + (2 * (self.width + 2) if lookups else 0))


def sweep_table(plan: SweepPlan, alpha, beta, gamma, non_residues, device,
                lookup_beta=None, lookup_gamma=None):
    """The uint64 scalar table: beta, gamma, non-residues, alpha powers (c0
    then c1) and, with lookups, beta' and the powers gamma'^0..gamma'^w as
    (c0, c1) pairs."""
    pows = ext_f.powers_s(alpha, plan.num_alpha)
    vals = [beta[0], beta[1], gamma[0], gamma[1]]
    vals += [int(k) for k in non_residues]
    vals += [p[0] for p in pows] + [p[1] for p in pows]
    if plan.R:
        vals += [lookup_beta[0], lookup_beta[1]]
        for g in ext_f.powers_s(lookup_gamma, plan.width + 1):
            vals += [g[0], g[1]]
    return gf.from_numpy(np.array(vals, dtype=np.uint64), device)


def coset_terms_plain(plan, wit, setup, s2, zs, xs, l0, zhinv, table):
    """The plain PyTorch sweep: interprets the same tables as the kernel."""
    n = xs.shape[0]
    Ct = plan.Ct
    tab = [gf.as_u64(v) for v in table.tolist()]
    beta, gamma = tuple(tab[0:2]), tuple(tab[2:4])
    ks = tab[4 : 4 + Ct]
    a0 = tab[4 + Ct : 4 + Ct + plan.num_alpha]
    a1 = tab[4 + Ct + plan.num_alpha :]
    consts = setup[Ct : Ct + plan.num_consts]
    prog = plan.prog_np.tolist()
    kvals = [int(v) for v in plan.kvals_np]
    zero = torch.zeros(n, dtype=torch.int64, device=xs.device)
    acc = (zero, zero)
    t = 0
    pc = 0

    def take(k):
        nonlocal pc
        pc += k
        return prog[pc - k : pc]

    (num_gates,) = take(1)
    for _ in range(num_gates):
        (path_len,) = take(1)
        path = take(path_len)
        reps, pw, const_off, _num_slots = take(4)
        sel = None
        for b, bit in enumerate(path):
            f = consts[b] if bit else gf.sub(1, consts[b])
            sel = f if sel is None else gf.mul(sel, f)
        body = pc
        gate_acc = (zero, zero)
        for inst in range(reps):
            pc = body
            slots = {}
            for _i in range(take(1)[0]):
                slot, kind, idx = take(3)
                if kind == LOAD_KINDS["v"]:
                    slots[slot] = wit[inst * pw + idx]
                else:
                    slots[slot] = consts[const_off + idx]
            for _i in range(take(1)[0]):
                slot, k = take(2)
                slots[slot] = kvals[k]
            for _i in range(take(1)[0]):
                op, dst, a, b = take(4)
                x, y = slots[a], slots[b]
                if op == OPCODES["add"]:
                    slots[dst] = gf.add(x, y)
                elif op == OPCODES["sub"]:
                    slots[dst] = gf.sub(x, y)
                elif op == OPCODES["mul"]:
                    slots[dst] = gf.mul(x, y)
                elif op == OPCODES["neg"]:
                    slots[dst] = gf.neg(x)
                else:
                    slots[dst] = gf.double(x)
            for slot in take(take(1)[0]):
                term = slots[slot]
                gate_acc = ext_f.add(gate_acc, (gf.mul(term, a0[t]), gf.mul(term, a1[t])))
                t += 1
        if sel is not None:
            gate_acc = ext_f.mul_by_base(gate_acc, sel)
        acc = ext_f.add(acc, gate_acc)
    # copy permutation
    z = (s2[0], s2[1])
    zm1 = (gf.sub(z[0], 1), z[1])
    acc = ext_f.add(acc, ext_f.mul(ext_f.mul_by_base(zm1, l0), (a0[t], a1[t])))
    t += 1
    chunks = chunk_columns(Ct, plan.chunk_deg)
    nums, dens = chunk_num_den(wit, setup, ks, xs, beta, gamma, chunks)
    prev = z
    for j in range(len(chunks)):
        lhs = (s2[2 + 2 * j], s2[3 + 2 * j]) if j + 1 < len(chunks) else (zs[0], zs[1])
        term = ext_f.sub(ext_f.mul(lhs, (dens[0][j], dens[1][j])),
                         ext_f.mul(prev, (nums[0][j], nums[1][j])))
        acc = ext_f.add(acc, ext_f.mul(term, (a0[t], a1[t])))
        t += 1
        prev = lhs
    if plan.R:
        R, w = plan.R, plan.width
        lk = tab[4 + Ct + 2 * plan.num_alpha :]
        lbeta = (lk[0], lk[1])
        gpow = [(lk[2 + 2 * j], lk[3 + 2 * j]) for j in range(w + 1)]
        ab = 2 * len(chunks)
        for i in range(R):
            cols = [wit[plan.Cg + i * w + j] for j in range(w)]
            den = aggregate_lookup_columns(cols, consts[plan.num_consts - 1], gpow, lbeta)
            term = ext_f.mul((s2[ab + 2 * i], s2[ab + 2 * i + 1]), den)
            term = (gf.sub(term[0], 1), term[1])
            acc = ext_f.add(acc, ext_f.mul(term, (a0[t], a1[t])))
            t += 1
        tcols = setup[Ct + plan.num_consts :]
        den = aggregate_lookup_columns([tcols[j] for j in range(w)], tcols[w], gpow, lbeta)
        term = ext_f.mul((s2[ab + 2 * R], s2[ab + 2 * R + 1]), den)
        term = (gf.sub(term[0], wit[Ct]), term[1])
        acc = ext_f.add(acc, ext_f.mul(term, (a0[t], a1[t])))
    return gf.mul(acc[0], zhinv), gf.mul(acc[1], zhinv)


def coset_terms(plan: SweepPlan, wit, setup, s2, zs, xs, l0, zhinv, table):
    """Quotient terms over one coset: (t0, t1), each (n,) (kernel B6).

    wit, setup and s2 are the coset evaluations of the witness, setup and
    stage-2 oracles in the plan's layout, zs (2, n) those of the shifted z;
    xs, l0, zhinv (n,) the coset's x, L0(x) and 1/Z_H(x)."""
    n = xs.shape[0]
    for t, what, rows in (
        (wit, "witness", plan.num_wit_rows), (setup, "setup", plan.num_setup_cols),
        (s2, "stage 2", plan.num_s2_rows), (zs, "shifted z", 2),
    ):
        K.require(t, f"sweep {what}", (rows, n))
    for t, what in ((xs, "xs"), (l0, "L0"), (zhinv, "1/Z_H")):
        K.require(t, f"sweep {what}", (n,))
    K.require(table, "sweep table", (plan.table_len,))
    dev = K.same_device(wit, setup, s2, zs, xs, l0, zhinv, table, plan.prog)
    if dev.type == "cpu":
        return coset_terms_plain(plan, wit, setup, s2, zs, xs, l0, zhinv, table)
    out0 = torch.empty(n, dtype=torch.int64, device=dev)
    out1 = torch.empty(n, dtype=torch.int64, device=dev)
    lib = K.library("quotient_sweep")
    with torch.cuda.device(dev):
        K.count("quotient_sweep")
        K.check(
            lib.bt_quotient_sweep(
                K.ptr(wit), K.ptr(setup), K.ptr(s2), K.ptr(zs), K.ptr(xs),
                K.ptr(l0), K.ptr(zhinv), K.ptr(table), K.ptr(plan.prog),
                K.ptr(plan.kvals), plan.Cg, plan.Ct, plan.num_consts,
                plan.chunk_deg, plan.num_alpha, plan.R, plan.width,
                n, K.ptr(out0), K.ptr(out1), K.stream(dev),
            ),
            "quotient_sweep",
        )
    return out0, out1
