"""Build the port's assembly and setup from plain arrays and ints.

The JAX package's `CSAssembly` and `SetupData` reduce to numpy arrays and
ints (placement, column values, gate names and order, public inputs, the
witness columns, sigma and constant columns, selector paths, non-residues
and, with lookups, the multiplicities and table stack, plus in specialized
mode the lookup placement and values and the table-id column). Feeding
those here gives the port the same circuit, so its prover can be held
against the JAX prover apart from synthesis. Nothing here imports the JAX
package.
"""

from __future__ import annotations

import numpy as np

from . import resolve_device
from .cs.gates import GATES_BY_NAME, LookupMarkerGate
from .cs.implementations import CSAssembly
from .cs.types import CSGeometry, LookupParameters
from .prover.setup import SetupData, commit_setup


def assembly_from_arrays(*, geometry, trace_len: int, gate_names, row_gate,
                         gate_constants, copy_placement, copy_values,
                         public_inputs, wit_placement=None, wit_values=None,
                         lookup_params=None, lookup_placement=None, lookup_values=None,
                         multiplicities=None, table_id_col=None,
                         table_stack=None) -> CSAssembly:
    """geometry: the four CSGeometry ints (copy, witness, constant columns,
    max degree); gate_constants: {row: tuple of ints}; public_inputs:
    [(column, row, value)]; wit_placement and wit_values (W, n) with witness
    columns. With lookups: lookup_params the four LookupParameters fields
    (width, repetitions, shared table id, specialized columns);
    multiplicities (n,); table_stack (width + 1, n), whose last row holds
    the table ids 1..T; in specialized mode also lookup_placement and
    lookup_values (R·width, n) and table_id_col (n,)."""
    geometry = CSGeometry(*(int(g) for g in geometry))
    unknown = [g for g in gate_names if g not in GATES_BY_NAME]
    if unknown:
        raise NotImplementedError(f"gates not ported: {unknown}")
    arrays = {}
    width = 0
    if lookup_params is not None:
        w, r, shared, specialized = lookup_params
        params = LookupParameters(int(w), int(r), bool(shared), bool(specialized))
        width = params.width
        table_stack = np.asarray(table_stack, dtype=np.uint64).copy()
        arrays = dict(
            lookup_params=params,
            multiplicities=np.asarray(multiplicities, dtype=np.uint64).copy(),
            table_stack=table_stack,
            num_lookup_tables=int(table_stack[-1].max()),
        )
        if specialized:
            arrays.update(
                lookup_placement=np.asarray(lookup_placement, dtype=np.int64).copy(),
                lookup_cols_values=np.asarray(lookup_values, dtype=np.uint64).copy(),
                lookup_table_id_col=np.asarray(table_id_col, dtype=np.uint64).copy(),
            )
    if wit_placement is not None:
        arrays.update(
            wit_placement=np.asarray(wit_placement, dtype=np.int64).copy(),
            wit_cols_values=np.asarray(wit_values, dtype=np.uint64).copy(),
        )

    def gate(name):
        if name == LookupMarkerGate.name:
            return LookupMarkerGate.instance(width)
        return GATES_BY_NAME[name].instance()

    return CSAssembly(
        geometry=geometry,
        trace_len=int(trace_len),
        gates=[gate(g) for g in gate_names],
        row_gate=np.asarray(row_gate, dtype=np.int32).copy(),
        gate_constants={
            int(r): tuple(int(c) for c in cs) for r, cs in gate_constants.items()
        },
        copy_placement=np.asarray(copy_placement, dtype=np.int64).copy(),
        copy_cols_values=np.asarray(copy_values, dtype=np.uint64).copy(),
        public_inputs=[(int(c), int(r), int(v)) for (c, r, v) in public_inputs],
        **arrays,
    )


def setup_from_arrays(assembly: CSAssembly, config, *, sigma_cols, constant_cols,
                      selector_paths, non_residues, quotient_degree: int,
                      device="cuda") -> SetupData:
    """Commit given setup columns on the device and build the VK. In
    specialized mode sigma_cols cover the lookup columns too and
    constant_cols end with the table-id column; with lookups the table
    stack comes from the assembly."""
    return commit_setup(
        assembly, config,
        np.asarray(sigma_cols, dtype=np.uint64),
        np.asarray(constant_cols, dtype=np.uint64),
        [[int(b) for b in p] for p in selector_paths],
        [int(k) for k in non_residues],
        int(quotient_degree),
        resolve_device(device),
    )
