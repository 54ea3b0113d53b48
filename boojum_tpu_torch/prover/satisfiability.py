"""Whether an assembly's witness satisfies its constraints, the check of the
JAX package's prover/satisfiability.py (era-boojum satisfiability_test.rs
`check_if_satisfied`): every placed gate instance's terms vanish, every
lookup tuple is a row of its table, and the multiplicity column counts the
placed tuples exactly.

The gates are evaluated over word tensors, all rows of a gate at once, by
the same `evaluate` the verifier runs at z; the tables are read from the
assembly's stacked table columns, so an assembly rebuilt from arrays
(compat.py) is checked as well as a synthesized one. Runs on the CPU: it
checks a circuit before a long prove.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cs.field_like import BBTensorOps, TensorOps
from ..cs.gates.base import RowView, TermsCollector
from ..field import babybear as bb
from ..field import goldilocks as gf


def _report(verbose: bool, message: str) -> bool:
    if verbose:
        print(message)
    return False


def check_if_satisfied(assembly, verbose: bool = False) -> bool:
    """True when every gate term vanishes and the lookups hold; with
    verbose, the first failure is printed."""
    ops, fm = (BBTensorOps, bb) if assembly.field == "babybear" else (TensorOps, gf)
    geometry = assembly.geometry
    copy = fm.from_numpy(assembly.copy_cols_values)
    wit = fm.from_numpy(assembly.wit_cols_values)
    row_gate = np.asarray(assembly.row_gate)
    for gid, gate in enumerate(assembly.gates):
        rows = np.nonzero(row_gate == gid)[0]
        if not gate.num_terms or not rows.size:
            continue
        consts = np.zeros((max(gate.num_constants, 1), rows.size), dtype=np.uint64)
        for k, r in enumerate(rows.tolist()):
            cs = assembly.gate_constants.get(r, ())
            consts[: len(cs), k] = cs
        consts = fm.from_numpy(consts)
        idx = torch.from_numpy(rows)
        for inst in range(gate.num_repetitions(geometry)):
            voff, woff = inst * gate.principal_width, inst * gate.witness_width
            view = RowView(lambda i, o=voff: copy[o + i, idx],
                           lambda i, o=woff: wit[o + i, idx],
                           lambda i: consts[i])
            dst = TermsCollector()
            gate.evaluate(ops, view, dst)
            for t, term in enumerate(dst.terms):
                bad = np.nonzero(fm.to_numpy(term) if not isinstance(term, int)
                                 else np.full(rows.size, term))[0]
                if bad.size:
                    return _report(verbose, f"UNSATISFIED: row {int(rows[bad[0]])} gate "
                                            f"{gate.name} instance {inst} term {t}")
    if assembly.lookups_enabled:
        return _check_lookups(assembly, verbose)
    return True


def _placed_tuples(assembly):
    """(table ids (m,), tuples (m, width)) of every placed lookup tuple,
    vacant slots' padding tuples included."""
    lp = assembly.lookup_params
    w = lp.width
    if assembly.lookup_mode == "specialized":
        R = lp.num_repetitions
        vals = np.asarray(assembly.lookup_cols_values, dtype=np.uint64)
        tids = np.asarray(assembly.lookup_table_id_col, dtype=np.uint64)
        cols = [vals[s * w : (s + 1) * w] for s in range(R)]
        return np.tile(tids, R), np.concatenate(cols, axis=1).T
    mk = assembly.lookup_marker_gid()
    rows = np.nonzero(np.asarray(assembly.row_gate) == mk)[0]
    reps = assembly.gates[mk].num_repetitions(assembly.geometry)
    tids = np.array([assembly.gate_constants.get(int(r), (0,))[0] for r in rows],
                    dtype=np.uint64)
    vals = np.asarray(assembly.copy_cols_values, dtype=np.uint64)[:, rows]
    cols = [vals[s * w : (s + 1) * w] for s in range(reps)]
    return np.tile(tids, reps), np.concatenate(cols, axis=1).T


def _check_lookups(assembly, verbose: bool) -> bool:
    w = assembly.lookup_params.width
    stack = np.asarray(assembly.table_stack, dtype=np.uint64)
    table_rows = np.nonzero(stack[w])[0]
    where = {tuple(int(v) for v in stack[:, r]): int(r) for r in table_rows}
    tids, tuples = _placed_tuples(assembly)
    keyed = np.concatenate([tuples, tids[:, None]], axis=1)
    uniq, counts = np.unique(keyed, axis=0, return_counts=True)
    expected = np.zeros(assembly.trace_len, dtype=np.uint64)
    for key, times in zip(uniq.tolist(), counts.tolist()):
        if key[-1] == 0:
            return _report(verbose, "LOOKUP: a tuple with no table id")
        r = where.get(tuple(key))
        if r is None:
            return _report(verbose, f"LOOKUP UNSATISFIED: tuple {tuple(key[:-1])} is not "
                                    f"a row of table {key[-1]}")
        expected[r] += times
    bad = np.nonzero(expected != np.asarray(assembly.multiplicities, dtype=np.uint64))[0]
    if bad.size:
        return _report(verbose, f"LOOKUP: multiplicity at stacked row {int(bad[0])}: the "
                                f"column says {int(assembly.multiplicities[bad[0]])}, the "
                                f"trace has {int(expected[bad[0]])}")
    return True
