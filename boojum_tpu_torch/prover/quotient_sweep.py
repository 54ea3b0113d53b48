"""The per-coset quotient sweep (kernel B6, csrc/quotient_sweep.cu).

Replaces boojum_tpu/prover/pallas_sweep.py build_coset_terms, its
standalone entries cp_quotient, lookup_quotient, lookup_quotient_general and
gate_terms_fn, and their XLA twins (prover.py _u64_sweep_core, the
stages.py cores). For each row of one quotient coset it sums, with alpha^t
weights in GF(p^2), three parts, each of which a launch may switch off:
- the gate terms of every instance of every gate, masked by the gate's
  selector-path product over the constant columns; a gate reads its copy
  cells, its witness-column cells and its constants;
- L0·(z - 1) and, per chunk of copy columns, lhs·prod(den) - rhs·prod(num)
  with num = w + beta·k·x + gamma, den = w + beta·sigma + gamma;
- with lookups, per sub-argument i: A_i·(Σ_j γ'^j·w_{i,j} + γ'^w·tid + β')
  - sel, and for the table: B·(Σ_j γ'^j·t_j + γ'^w·t_id + β') - M. In
  specialized mode the tuples are the lookup copy columns, tid the table-id
  column and sel 1; in general mode the tuples are the general copy
  columns, tid the marker's constant column and sel the marker's selector
  over the constant columns;
then, in the full sweep, multiplies by 1/Z_H. Terms take alpha powers in the
JAX package's order: every gate term first (gate order, instance, term),
then the copy-permutation terms, then the lookup sub-arguments and B.

Gates reach the kernel as data: each gate's captured op program
(cs/gate_capture.py), its slots renumbered by liveness (`schedule_program`),
is encoded into an int32 table that the kernel and the plain version below
both interpret, so the CPU tests check the encoding. Each term is folded
into its gate's sum by an instruction of its own as soon as its value
exists, so a finished term holds no slot.
The scalar table ends with entries only the kernel reads (β·k_i per copy
column, 7·α^t.c1), which save it products; `kernel_entries` defines them.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels as K
from ..cs.gate_capture import OPCODES, capture_gate_program
from ..field import extension as ext_f
from ..field import gl
from ..field import goldilocks as gf
from .layout import OracleLayout, chunk_columns

MAX_SLOTS = 32  # csrc/quotient_sweep.cu kMaxSlots
# a program table longer than this is read from global memory through the
# read-only cache, not copied into shared memory (kSmemProgBytes)
SMEM_PROG_BYTES = 32 * 1024
SMEM_BYTES = 227 * 1024  # the most shared memory a Hopper block may take
GATES, COPY_PERMUTATION, LOOKUPS = 1, 2, 4  # parts of a launch
ALL_PARTS = GATES | COPY_PERMUTATION | LOOKUPS


def chunk_num_den(copy_vals, sigma_vals, non_residues, xs, beta, gamma, chunks):
    """Per chunk of copy columns, the products of num = w + beta·k·x + gamma
    and den = w + beta·sigma + gamma, each a (num_chunks, n) ext pair. The
    chunks are contiguous runs of columns (layout.chunk_columns); every
    column's factors are made at once, then multiplied position by position
    across the chunks."""
    cols = [c for chunk in chunks for c in chunk]
    if cols != list(range(len(cols))):
        raise ValueError("chunks must be contiguous runs of columns from 0")
    Ct, deg = len(cols), max(len(c) for c in chunks)
    ks = gf.from_numpy(np.array([int(non_residues[c]) for c in cols], dtype=np.uint64),
                       xs.device)[:, None]
    w, sig = copy_vals[:Ct], sigma_vals[:Ct]
    kx = gf.mul(xs[None], ks)
    nums = (gf.add(gf.add(w, gf.mul(kx, beta[0])), gamma[0]),
            gf.add(gf.mul(kx, beta[1]), gamma[1]))
    dens = (gf.add(gf.add(w, gf.mul(sig, beta[0])), gamma[0]),
            gf.add(gf.mul(sig, beta[1]), gamma[1]))

    def products(pair):
        # pad the last chunk with ones to deg columns: (num_chunks, deg, n)
        pad = len(chunks) * deg - Ct
        if pad:
            one = torch.ones((pad,) + tuple(xs.shape), dtype=torch.int64, device=xs.device)
            pair = (torch.cat([pair[0], one]), torch.cat([pair[1], torch.zeros_like(one)]))
        c0, c1 = (t.reshape(len(chunks), deg, -1) for t in pair)
        acc = (c0[:, 0], c1[:, 0])
        for j in range(1, deg):
            acc = ext_f.mul(acc, (c0[:, j], c1[:, j]))
        return acc

    return products(nums), products(dens)


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


def selector_from_consts(consts, path):
    """Product over the path bits of c_b or 1 - c_b over the constant
    columns; None for an empty path (the constant 1)."""
    sel = None
    for b, bit in enumerate(path):
        f = consts[b] if bit else gf.sub(1, consts[b])
        sel = f if sel is None else gf.mul(sel, f)
    return sel


def num_gate_terms(gates, geometry) -> int:
    return sum(g.num_repetitions(geometry) * g.num_terms for g in gates if g.num_terms)


# the goldilocks.cuh primitive the kernel runs for each gate op
KERNEL_OP = {"add": "add_lazy", "sub": "sub_lazy", "mul": "mul_lazy", "neg": "sub_lazy",
             "double": "add_lazy"}
# instructions past the ops: a load from the witness oracle's columns or from
# the constant columns, (op, dst, column, stride); a constant, (op, dst,
# index into kvals, 0); a term, (op, term index, slot, 0), which adds
# slot·α^(the gate's first term + index) to the gate's sum
LOAD_COLS, LOAD_CONSTS, CONST, TERM = 5, 6, 7, 8


def schedule_program(p):
    """A captured program as one stream of instructions over slots reused by
    liveness: each load and constant is placed just before its first use,
    each term is folded into the gate's sum just after its value is made,
    and a result takes the lowest free slot, which may be an operand's that
    dies at that op. Returns (instructions as (op, dst, a, b) with `a` a
    load's (kind, index) or a constant's value, a term's op ("term", index)
    with `a` its slot; the slot each term is folded from; slots used). The
    ops and their order are the program's, so the values are too, and the
    gate's sum is the same sum in another order."""
    defs = {slot: ("load", kind, idx) for slot, kind, idx in p.loads}
    defs.update({slot: ("const", value) for slot, value in p.consts})
    terms_of = {}
    for i, t in enumerate(p.terms):
        terms_of.setdefault(t, []).append(i)
    stream = []  # (op, dst, operands) over SSA slots; a term has no dst
    placed = set()

    def made(v):
        stream.extend((("term", i), None, (v,)) for i in terms_of.get(v, ()))

    def place(v):
        if v in defs and v not in placed:
            placed.add(v)
            stream.append((defs[v], v, ()))
            made(v)

    for op, dst, a, b in p.ops:
        place(a)
        place(b)
        stream.append((op, dst, (a,) if op in ("neg", "double") else (a, b)))
        made(dst)
    for t in p.terms:
        place(t)
    last = {}
    for i, (_op, dst, args) in enumerate(stream):
        last[dst] = i
        for v in args:
            last[v] = i
    free, phys, out, num_slots = [], {}, [], 0
    term_slots = [None] * len(p.terms)
    for i, (op, dst, args) in enumerate(stream):
        srcs = [phys[v] for v in args]
        for v in dict.fromkeys(args):
            if last[v] == i:
                free.append(phys[v])
        free.sort()
        if dst is None:
            term_slots[op[1]] = srcs[0]
            out.append((op, None, srcs[0], None))
            continue
        if free:
            phys[dst] = free.pop(0)
        else:
            phys[dst] = num_slots
            num_slots += 1
        if last[dst] == i:  # a result nothing reads
            free.append(phys[dst])
        if isinstance(op, tuple):
            out.append((op, phys[dst], op[1:], None))
        else:
            out.append((op, phys[dst], *(srcs * 2)[:2]))
    return out, term_slots, num_slots


def encode_gate_programs(gates, selector_paths, geometry, wit_col):
    """(int32 program table, uint64 constant values, the most slots a
    program uses, the kernel's operations a row by primitive, as
    `kernel_ops` counts them) for every gate with quotient terms, in gate
    order (layout in csrc/quotient_sweep.cu). Each gate's captured program
    is scheduled by `schedule_program`; a gate whose schedule needs more
    than MAX_SLOTS slots is refused, by name. Each distinct constant is
    stored once. A load names its block (the witness
    oracle's columns, the witness columns from `wit_col` on, or the
    constant columns) and its column as base + instance·stride. Every cell
    a program loads lies inside the geometry's copy, witness and constant
    columns, which the kernel relies on."""
    num_consts = geometry.num_constant_columns
    prog = [0]
    kvals = {}  # value: its index
    num_slots = 0
    ops = Counter()
    for gid, gate in enumerate(gates):
        if not gate.num_terms:
            continue
        p = capture_gate_program(gate)
        ins, terms, slots = schedule_program(p)
        if slots > MAX_SLOTS:
            raise ValueError(f"gate {gate.name}: {slots} slots > {MAX_SLOTS}")
        num_slots = max(num_slots, slots)
        if len(terms) != gate.num_terms:
            raise ValueError(f"gate {gate.name}: term count mismatch")
        path = selector_paths[gid]
        reps, pw, ww = (gate.num_repetitions(geometry), gate.principal_width,
                        gate.witness_width)
        limits = {"v": pw, "w": ww, "c": num_consts - len(path)}
        for _slot, kind, idx in p.loads:
            if not 0 <= idx < limits[kind]:
                raise ValueError(f"gate {gate.name}: {kind} load {idx} outside {limits[kind]}")
        if (reps < 1 or reps * pw > geometry.num_columns_under_copy_permutation
                or reps * ww > geometry.num_witness_columns or len(path) > num_consts):
            raise ValueError(f"gate {gate.name} does not fit the geometry")
        prog[0] += 1
        prog += [len(path), *path, reps, slots, len(ins)]
        # (opcode, base, stride) of each load kind
        where = {"v": (LOAD_COLS, 0, pw), "w": (LOAD_COLS, wit_col, ww),
                 "c": (LOAD_CONSTS, len(path), 0)}
        for op, dst, a, b in ins:
            if op[0] == "load":
                code, base, stride = where[a[0]]
                prog += [code, dst, base + a[1], stride]
            elif op[0] == "const":
                prog += [CONST, dst, kvals.setdefault(a[0], len(kvals)), 0]
            elif op[0] == "term":
                prog += [TERM, op[1], a, 0]
            else:
                prog += [OPCODES[op], dst, a, b]
                ops[KERNEL_OP[op]] += reps
        prog.append(len(terms))
        ops["acc_mac"] += 2 * len(terms) * reps  # Σ term·α^t
        if path:  # the selector, then the reduced sum times it
            ops.update(mul_lazy=len(path), sub=path.count(0), reduce_acc_lazy=2, acc_mac=2)
        else:
            ops["acc_add"] += 2
    return prog, list(kvals), num_slots, ops


def encode_lookup_header(layout: OracleLayout) -> list:
    """R, width, the first tuple column, the table id's constant column and
    the selector path (empty in specialized mode, where sel is 1)."""
    if not layout.lookups:
        return [0, 0, 0, 0, 0]
    path = list(layout.marker_path)
    return [layout.R, layout.width, layout.lookup_col_base, layout.tid_const,
            len(path), *path]


class SweepPlan:
    """The structure of one circuit's sweep: the program table on a device
    and the counts the kernel needs. Row layout: `layout`
    (prover/layout.py)."""

    def __init__(self, gates, selector_paths, geometry, num_copy_cols, device,
                 lookup_params=None):
        layout = OracleLayout.build(geometry, lookup_params, gates, selector_paths)
        if num_copy_cols != layout.Ct:
            raise ValueError(f"{num_copy_cols} copy columns do not fit the layout's "
                             f"{layout.Ct}")
        self._init(layout, gates, selector_paths, geometry, ALL_PARTS, device)

    @classmethod
    def entry(cls, layout, gates, selector_paths, geometry, parts, device):
        """A plan for the parts `parts` alone (a standalone entry)."""
        plan = cls.__new__(cls)
        plan._init(layout, gates, selector_paths, geometry, parts, device)
        return plan

    def _init(self, layout, gates, selector_paths, geometry, parts, device):
        if not layout.lookups:
            parts &= ~LOOKUPS
        gate_prog, kvals, self.num_slots, self.gate_ops = ([0], [], 0, Counter())
        if parts & GATES:
            gate_prog, kvals, self.num_slots, self.gate_ops = encode_gate_programs(
                gates, selector_paths, geometry, layout.wit_col)
        self.layout = layout
        self.parts = parts
        self.gate_names = [g.name for g in gates if g.num_terms] if parts & GATES else []
        self.prog_np = np.array(encode_lookup_header(layout) + gate_prog, dtype=np.int32)
        self.kvals_np = np.array(kvals, dtype=np.uint64)
        self.prog = torch.from_numpy(self.prog_np).to(device)
        self.kvals = gf.from_numpy(kvals if kvals else np.zeros(1, np.uint64), device)
        self.Ct = layout.Ct if parts & COPY_PERMUTATION else 0
        self.chunk_deg = max(1, layout.max_degree)
        self.num_gate_terms = num_gate_terms(gates, geometry) if parts & GATES else 0
        self.num_alpha = (self.num_gate_terms
                          + (1 + layout.num_chunks if parts & COPY_PERMUTATION else 0)
                          + (layout.R + 1 if parts & LOOKUPS else 0))
        self.table_len = (4 + self.Ct + 2 * self.num_alpha
                          + (2 * (layout.width + 2) if parts & LOOKUPS else 0)
                          + 2 * self.Ct + self.num_alpha)

    def operand_shapes(self, n: int) -> dict:
        """The shape of every operand block the plan's parts read (the
        kernel reads nothing else)."""
        lo = self.layout
        shapes = {"cols": (lo.Ct + lo.W, n)}
        if self.parts & GATES:
            shapes.update(consts=(lo.K, n))
        if self.parts & COPY_PERMUTATION:
            shapes.update(sigma=(lo.Ct, n), s2=(lo.ab_row, n), zs=(2, n), xs=(n,), l0=(n,))
        if self.parts & LOOKUPS:
            shapes.update(consts=(lo.K, n), tables=(lo.width + 1, n),
                          lk=(2 * (lo.R + 1), n), mult=(n,))
        return shapes

    @property
    def num_wit_rows(self) -> int:
        return self.layout.num_wit_rows

    @property
    def num_setup_cols(self) -> int:
        return self.layout.num_setup_rows

    @property
    def num_s2_rows(self) -> int:
        return self.layout.num_s2_rows


def kernel_entries(alpha_pows, beta, non_residues) -> list:
    """The scalar table's last entries, read by the kernel alone: (β.c0·k_i,
    β.c1·k_i) per copy column, so num = w + γ + (β·k_i)·x takes two products,
    and 7·α^t.c1 per alpha power, so an α-weighted GF(p^2) term takes four
    (its c0 is t.c0·α.c0 + t.c1·7α.c1)."""
    b0, b1 = int(beta[0]) % gl.P, int(beta[1]) % gl.P
    vals = [v for k in non_residues for v in (b0 * int(k) % gl.P, b1 * int(k) % gl.P)]
    return vals + [7 * int(a[1]) % gl.P for a in alpha_pows]


def scalar_table(plan: SweepPlan, alpha_pows, beta=(0, 0), gamma=(0, 0), non_residues=(),
                 lookup_beta=(0, 0), lookup_gamma=(0, 0), device="cpu"):
    """The uint64 scalar table: beta, gamma, the Ct non-residues, the alpha
    powers (c0 then c1) and, with lookups, beta' and the powers
    gamma'^0..gamma'^w as (c0, c1) pairs; then `kernel_entries`."""
    if len(alpha_pows) != plan.num_alpha or len(non_residues) != plan.Ct:
        raise ValueError(f"the plan takes {plan.num_alpha} alpha powers and "
                         f"{plan.Ct} non-residues")
    vals = [beta[0], beta[1], gamma[0], gamma[1]]
    vals += [int(k) for k in non_residues]
    vals += [p[0] for p in alpha_pows] + [p[1] for p in alpha_pows]
    if plan.parts & LOOKUPS:
        vals += [lookup_beta[0], lookup_beta[1]]
        for g in ext_f.powers_s(lookup_gamma, plan.layout.width + 1):
            vals += [g[0], g[1]]
    vals += kernel_entries(alpha_pows, beta, non_residues)
    return gf.from_numpy(np.array(vals, dtype=np.uint64), device)


def sweep_table(plan: SweepPlan, alpha, beta, gamma, non_residues, device,
                lookup_beta=None, lookup_gamma=None):
    """The full sweep's scalar table from the challenges."""
    return scalar_table(plan, ext_f.powers_s(alpha, plan.num_alpha), beta, gamma,
                        non_residues, lookup_beta or (0, 0), lookup_gamma or (0, 0), device)


@dataclass
class Operands:
    """The column blocks one launch reads, each (rows, n) with row stride n;
    a block a launch's parts do not read may be None. zhinv None: the terms
    are not multiplied by 1/Z_H."""

    n: int
    cols: torch.Tensor | None = None  # copy columns (Ct), then witness columns (W)
    mult: torch.Tensor | None = None  # multiplicities (n,)
    sigma: torch.Tensor | None = None  # sigma columns (Ct)
    consts: torch.Tensor | None = None  # constant columns
    tables: torch.Tensor | None = None  # stacked table columns (width + 1)
    s2: torch.Tensor | None = None  # z and the partial products
    lk: torch.Tensor | None = None  # A_i and B pairs
    zs: torch.Tensor | None = None  # z(w·x) pair
    xs: torch.Tensor | None = None
    l0: torch.Tensor | None = None
    zhinv: torch.Tensor | None = None

    FIELDS = ("cols", "mult", "sigma", "consts", "tables", "s2", "lk", "zs", "xs", "l0",
              "zhinv")

    def tensors(self):
        return [getattr(self, f) for f in self.FIELDS]


def split_oracles(plan: SweepPlan, wit, setup, s2, zs, xs, l0, zhinv) -> Operands:
    """The full sweep's operands from the coset evaluations of the witness,
    setup and stage-2 oracles in the plan's layout."""
    lo = plan.layout
    n = xs.shape[0]
    for t, what, rows in (
        (wit, "witness", lo.num_wit_rows), (setup, "setup", lo.num_setup_rows),
        (s2, "stage 2", lo.num_s2_rows), (zs, "shifted z", 2),
    ):
        K.require(t, f"sweep {what}", (rows, n))
    for t, what in ((xs, "xs"), (l0, "L0"), (zhinv, "1/Z_H")):
        K.require(t, f"sweep {what}", (n,))
    Ct, W = lo.Ct, lo.W
    return Operands(
        n=n, cols=wit[: Ct + W], mult=wit[lo.mult_row] if lo.lookups else None,
        sigma=setup[:Ct], consts=setup[Ct : Ct + lo.K],
        tables=setup[lo.table_row :] if lo.lookups else None,
        s2=s2[: lo.ab_row], lk=s2[lo.ab_row :] if lo.lookups else None,
        zs=zs, xs=xs, l0=l0, zhinv=zhinv,
    )


def sweep_plain(plan: SweepPlan, ops: Operands, table):
    """The plain PyTorch sweep: interprets the same tables as the kernel."""
    n = ops.n
    Ct = plan.Ct
    tab = [gf.as_u64(v) for v in table.tolist()]
    beta, gamma = tuple(tab[0:2]), tuple(tab[2:4])
    ks = tab[4 : 4 + Ct]
    a0 = tab[4 + Ct : 4 + Ct + plan.num_alpha]
    a1 = tab[4 + Ct + plan.num_alpha : 4 + Ct + 2 * plan.num_alpha]
    consts = ops.consts
    prog = plan.prog_np.tolist()
    kvals = [int(v) for v in plan.kvals_np]
    zero = torch.zeros(n, dtype=torch.int64, device=table.device)
    acc = (zero, zero)
    t = 0
    pc = 0

    def take(k):
        nonlocal pc
        pc += k
        return prog[pc - k : pc]

    R, w, col_base, tid_const, mk_len = take(5)
    mk_path = take(mk_len)
    (num_gates,) = take(1)
    for _ in range(num_gates if plan.parts & GATES else 0):
        (path_len,) = take(1)
        sel = selector_from_consts(consts, take(path_len))
        reps, _num_slots, num_ins = take(3)
        body = pc
        num_terms = prog[body + 4 * num_ins]
        gate_acc = (zero, zero)
        for inst in range(reps):
            pc = body
            slots = {}
            for _i in range(num_ins):
                op, dst, a, b = take(4)
                if op in (LOAD_COLS, LOAD_CONSTS):
                    slots[dst] = (ops.cols if op == LOAD_COLS else consts)[a + inst * b]
                elif op == CONST:
                    slots[dst] = kvals[a]
                elif op == TERM:
                    term = slots[a]
                    gate_acc = ext_f.add(gate_acc, (gf.mul(term, a0[t + dst]),
                                                    gf.mul(term, a1[t + dst])))
                elif op == OPCODES["add"]:
                    slots[dst] = gf.add(slots[a], slots[b])
                elif op == OPCODES["sub"]:
                    slots[dst] = gf.sub(slots[a], slots[b])
                elif op == OPCODES["mul"]:
                    slots[dst] = gf.mul(slots[a], slots[b])
                elif op == OPCODES["neg"]:
                    slots[dst] = gf.neg(slots[a])
                else:
                    slots[dst] = gf.double(slots[a])
            t += num_terms
        pc += 1  # past num_terms
        if sel is not None:
            gate_acc = ext_f.mul_by_base(gate_acc, sel)
        acc = ext_f.add(acc, gate_acc)
    if plan.parts & COPY_PERMUTATION:
        s2 = ops.s2
        z = (s2[0], s2[1])
        zm1 = (gf.sub(z[0], 1), z[1])
        acc = ext_f.add(acc, ext_f.mul(ext_f.mul_by_base(zm1, ops.l0), (a0[t], a1[t])))
        t += 1
        chunks = chunk_columns(Ct, plan.chunk_deg)
        nums, dens = chunk_num_den(ops.cols, ops.sigma, ks, ops.xs, beta, gamma, chunks)
        prev = z
        for j in range(len(chunks)):
            lhs = ((s2[2 + 2 * j], s2[3 + 2 * j]) if j + 1 < len(chunks)
                   else (ops.zs[0], ops.zs[1]))
            term = ext_f.sub(ext_f.mul(lhs, (dens[0][j], dens[1][j])),
                             ext_f.mul(prev, (nums[0][j], nums[1][j])))
            acc = ext_f.add(acc, ext_f.mul(term, (a0[t], a1[t])))
            t += 1
            prev = lhs
    if plan.parts & LOOKUPS:
        lk = tab[4 + Ct + 2 * plan.num_alpha :]  # beta', the gamma'^j pairs
        lbeta = (lk[0], lk[1])
        gpow = [(lk[2 + 2 * j], lk[3 + 2 * j]) for j in range(w + 1)]
        sel = selector_from_consts(consts, mk_path)
        for i in range(R):
            cols = [ops.cols[col_base + i * w + j] for j in range(w)]
            den = aggregate_lookup_columns(cols, consts[tid_const], gpow, lbeta)
            term = ext_f.mul((ops.lk[2 * i], ops.lk[2 * i + 1]), den)
            term = (gf.sub(term[0], 1 if sel is None else sel), term[1])
            acc = ext_f.add(acc, ext_f.mul(term, (a0[t], a1[t])))
            t += 1
        tcols = ops.tables
        den = aggregate_lookup_columns([tcols[j] for j in range(w)], tcols[w], gpow, lbeta)
        term = ext_f.mul((ops.lk[2 * R], ops.lk[2 * R + 1]), den)
        term = (gf.sub(term[0], ops.mult), term[1])
        acc = ext_f.add(acc, ext_f.mul(term, (a0[t], a1[t])))
    if ops.zhinv is None:
        return acc
    return gf.mul(acc[0], ops.zhinv), gf.mul(acc[1], ops.zhinv)


def kernel_ops(plan: SweepPlan, zhinv: bool) -> Counter:
    """The field operations a row of the kernel runs, by goldilocks.cuh
    primitive (lazy ops, 128-bit products summed into accumulators, their
    reductions, the lazy GF(p^2) product, canonical `sub`), with β·k_i and
    7·α^t from the table; loads, addressing and the program's decoding not
    counted. What a row's own arithmetic costs, for its bound."""
    ops = Counter(plan.gate_ops)
    lo = plan.layout
    if plan.parts & COPY_PERMUTATION:
        Ct, chunks = plan.Ct, -(-plan.Ct // plan.chunk_deg)
        ops.update(
            sub=1, mul_lazy=2,  # L0 (z - 1)
            acc_add=Ct + 2,  # w + γ, then into the row's sum
            acc_mac=4 * Ct + 4 * (1 + chunks),  # num and den, the α terms
            reduce_acc_lazy=4 * Ct,
            ext_mul_lazy=2 * Ct,  # 2 (d - 1) a chunk, then lhs·den and prev·num
            sub_lazy=2 * chunks,
        )
    if plan.parts & LOOKUPS:
        R, path = lo.R, list(lo.marker_path)
        macs = 1 + R * lo.width + lo.width + 1  # β', the tuples, the table
        ops.update(acc_mac=2 * macs + 4 * (R + 1), mul_lazy=len(path), sub=path.count(0),
                   reduce_acc_lazy=2 * (R + 1), ext_mul_lazy=R + 1, sub_lazy=R + 1,
                   acc_add=2)
    ops.update(reduce_acc_lazy=2, mul_lazy=2 if zhinv else 0)
    return ops


def launch_geometry(n: int, parts: int) -> tuple[int, int, int]:
    """The kernel's launch geometry (rows a thread, threads a block,
    sub-threads a row) for n rows, set by measurement on the H100 (PERF.md,
    B6); one of the instantiations of csrc/quotient_sweep.cu."""
    if n < 1 << 18:  # too few rows a thread to fill the card: split rows
        return (1, 256, 2)
    return (2, 256, 1) if parts & GATES else (1, 128, 1)


def prog_in_shared(plan: SweepPlan) -> bool:
    """Whether the kernel copies the plan's program table into shared
    memory (else it reads it from global memory)."""
    return 4 * len(plan.prog_np) <= SMEM_PROG_BYTES


def shared_bytes(plan: SweepPlan, rows_per_thread: int, threads: int, split: int) -> int:
    """The shared memory a block of the kernel takes (csrc/quotient_sweep.cu
    launch): the scalar table, the constants, every thread's slots, the
    sub-threads' partial sums and, if it fits, the program."""
    r_t = rows_per_thread * threads
    return (8 * (plan.table_len + len(plan.kvals_np)) + 8 * plan.num_slots * r_t
            + (16 * r_t if split > 1 else 0)
            + (4 * len(plan.prog_np) if prog_in_shared(plan) else 0))


def sweep(plan: SweepPlan, ops: Operands, table):
    """The terms of one launch: (t0, t1), each (n,) (kernel B6)."""
    K.require(table, "sweep table", (plan.table_len,))
    shapes = plan.operand_shapes(ops.n)
    if ops.zhinv is not None:
        shapes["zhinv"] = (ops.n,)
    for field, shape in shapes.items():
        K.require(getattr(ops, field), f"sweep {field}", shape)
    present = [t for t in ops.tensors() if t is not None]
    dev = K.same_device(table, plan.prog, *present)
    if dev.type == "cpu":
        return sweep_plain(plan, ops, table)
    out0 = torch.empty(ops.n, dtype=torch.int64, device=dev)
    out1 = torch.empty(ops.n, dtype=torch.int64, device=dev)
    rows_per_thread, threads, split = launch_geometry(ops.n, plan.parts)
    smem = shared_bytes(plan, rows_per_thread, threads, split)
    if smem > SMEM_BYTES:
        raise ValueError(f"sweep of gates {plan.gate_names}: {smem} bytes of shared memory "
                         f"a block > {SMEM_BYTES}")
    lib = K.library("quotient_sweep")
    with torch.cuda.device(dev):
        K.count("quotient_sweep")
        K.check(
            lib.bt_quotient_sweep(
                *(K.ptr(t) for t in ops.tensors()), K.ptr(table), plan.table_len,
                K.ptr(plan.prog), len(plan.prog_np), K.ptr(plan.kvals),
                len(plan.kvals_np), plan.Ct, plan.chunk_deg, plan.num_alpha, plan.parts,
                plan.num_slots, ops.n, rows_per_thread, threads, split, K.ptr(out0),
                K.ptr(out1), K.stream(dev),
            ),
            "quotient_sweep",
        )
    return out0, out1


def coset_terms_plain(plan, wit, setup, s2, zs, xs, l0, zhinv, table):
    """The plain version of coset_terms."""
    return sweep_plain(plan, split_oracles(plan, wit, setup, s2, zs, xs, l0, zhinv), table)


def coset_terms(plan: SweepPlan, wit, setup, s2, zs, xs, l0, zhinv, table):
    """Quotient terms over one coset: (t0, t1), each (n,).

    wit, setup and s2 are the coset evaluations of the witness, setup and
    stage-2 oracles in the plan's layout, zs (2, n) those of the shifted z;
    xs, l0, zhinv (n,) the coset's x, L0(x) and 1/Z_H(x)."""
    return sweep(plan, split_oracles(plan, wit, setup, s2, zs, xs, l0, zhinv), table)


# ---------------------------------------------------------------------------
# Standalone entries: one part each, same launch, no 1/Z_H. Each *_launch
# builds (plan, operands, scalar table) for sweep() or sweep_plain().
# ---------------------------------------------------------------------------


def cp_quotient_launch(s2, zs, copy, sigma, xs, l0, beta, gamma, alpha_pows,
                       non_residues, max_degree):
    Ct = copy.shape[0]
    layout = OracleLayout(Cg=Ct, W=0, num_geometry_consts=0, max_degree=max_degree)
    plan = SweepPlan.entry(layout, [], [], None, COPY_PERMUTATION, copy.device)
    table = scalar_table(plan, alpha_pows, beta, gamma, non_residues, device=copy.device)
    return plan, Operands(n=xs.shape[0], cols=copy, sigma=sigma, s2=s2, zs=zs, xs=xs,
                          l0=l0), table


def cp_quotient(*args):
    """The copy-permutation terms alone (pallas_sweep.py cp_quotient):
    (s2, zs, copy, sigma, xs, l0, beta, gamma, alpha_pows, non_residues,
    max_degree) with s2 (2·chunks, n) = [z | partials], zs (2, n) the
    shifted z, copy and sigma (Ct, n), and 1 + chunks alpha powers (host
    ext scalars)."""
    return sweep(*cp_quotient_launch(*args))


def _lookup_launch(ab, cols, consts, marker_path, tables, mult, lookup_beta, lookup_gamma,
                   alpha_pows, num_subargs, width):
    R, w = int(num_subargs), int(width)
    layout = OracleLayout(Cg=R * w, W=0, num_geometry_consts=consts.shape[0], max_degree=1,
                          mode="general", width=w, R=R, marker_path=marker_path)
    plan = SweepPlan.entry(layout, [], [], None, LOOKUPS, cols.device)
    table = scalar_table(plan, alpha_pows, lookup_beta=lookup_beta,
                         lookup_gamma=lookup_gamma, device=cols.device)
    return plan, Operands(n=mult.shape[0], cols=cols, mult=mult, consts=consts,
                          tables=tables, lk=ab), table


def lookup_quotient_launch(ab, lookup_cols, table_id, tables, mult, lookup_beta,
                           lookup_gamma, alpha_pows, num_repetitions, width):
    return _lookup_launch(ab, lookup_cols, table_id[None], (), tables, mult, lookup_beta,
                          lookup_gamma, alpha_pows, num_repetitions, width)


def lookup_quotient(*args):
    """The specialized lookup terms alone (pallas_sweep.py lookup_quotient):
    (ab, lookup_cols, table_id, tables, mult, lookup_beta, lookup_gamma,
    alpha_pows, num_repetitions, width) with ab (2(R + 1), n) = [A_0 c0,
    A_0 c1, ..., B c0, B c1], lookup_cols (R·width, n), table_id and mult
    (n,), tables (width + 1, n) and R + 1 alpha powers."""
    return sweep(*lookup_quotient_launch(*args))


def lookup_quotient_general_launch(ab, gen_cols, table_id, tables, mult, sel, lookup_beta,
                                   lookup_gamma, alpha_pows, num_subargs, width):
    return _lookup_launch(ab, gen_cols, torch.stack([sel, table_id]), (1,), tables, mult,
                          lookup_beta, lookup_gamma, alpha_pows, num_subargs, width)


def lookup_quotient_general(*args):
    """The general-mode lookup terms alone (pallas_sweep.py
    lookup_quotient_general): as lookup_quotient over the general copy
    columns, with the marker selector `sel` (n,) after mult, each A_i·den_i
    minus sel."""
    return sweep(*lookup_quotient_general_launch(*args))


def gate_terms_fn(gates, selector_paths, geometry, device="cuda"):
    """The gate terms alone (pallas_sweep.py gate_terms_fn): returns
    fn(copy (Cg, n), wit (W, n) or None, consts (K, n), alpha_pows);
    fn.launch takes the same arguments and builds the launch."""
    plan = SweepPlan.entry(OracleLayout.build(geometry), gates, selector_paths, geometry,
                           GATES, device)

    def launch(copy, wit, consts, alpha_pows):
        table = scalar_table(plan, alpha_pows, device=copy.device)
        cols = copy if wit is None else torch.cat([copy, wit])
        return plan, Operands(n=copy.shape[1], cols=cols, consts=consts), table

    def fn(*args):
        return sweep(*launch(*args))

    fn.launch = launch
    return fn
