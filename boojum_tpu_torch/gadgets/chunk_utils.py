"""4-bit chunk range checks and recomposition, as in the JAX package's
gadgets/chunk_utils.py: membership rides the TriXor4 table (a chunk in any
key column of a TriXor4 lookup lies in [0, 16)), or, in a circuit without
lookups, each chunk's four booleans; recomposition is a chain of
ReductionGates."""

from __future__ import annotations

from ..cs.gates.simple import ReductionGate
from ..native import OP_SPLIT
from .tables import trixor4_table


def range_check_chunks_batched(cs, chunks, table_id=None):
    """4-bit membership checks through TriXor4, three chunks a lookup; with
    no lookups configured, each chunk spread into four booleans."""
    if not chunks:
        return
    if not cs.lookup_params.is_enabled:
        from .num import Num

        for c in chunks:
            Num(c).spread_into_bits(cs, 4)
        return
    if table_id is None:
        table_id = cs.ensure_table("trixor4", trixor4_table)
    zero = cs.zero_var()
    for i in range(0, len(chunks), 3):
        batch = list(chunks[i : i + 3])
        while len(batch) < 3:
            batch.append(zero)
        cs.perform_lookup(table_id, batch)


def enforce_chunk_recomposition(cs, chunks, var, bits_per_chunk=4):
    """Enforce var == Σ chunk_i · 2^(bits·i) through a ReductionGate chain."""
    acc = None
    shift = 0
    rem = list(chunks)
    while rem:
        part, rem = rem[:3], rem[3:]
        vars4, cf = [], []
        if acc is not None:
            vars4.append(acc)
            cf.append(1)
        for c in part:
            vars4.append(c)
            cf.append(1 << shift)
            shift += bits_per_chunk
        while len(vars4) < 4:
            vars4.append(cs.zero_var())
            cf.append(0)
        if rem:
            acc = ReductionGate.reduce(cs, vars4, cf)
        else:
            ReductionGate.enforce_reduce(cs, vars4, cf, var)


def decompose_and_check(cs, var, num_bits):
    """Split var into range-checked 4-bit chunks and enforce their
    recomposition; returns the chunks."""
    if num_bits % 4:
        raise ValueError("num_bits must be a multiple of 4")
    k = num_bits // 4
    chunks = cs.alloc_multiple_variables_without_values(k)
    cs.set_values_with_dependencies(
        [var], chunks, lambda v: [(v[0] >> (4 * i)) & 0xF for i in range(k)],
        (OP_SPLIT, (4,)))
    enforce_chunk_recomposition(cs, chunks, var)
    range_check_chunks_batched(cs, chunks)
    return chunks
