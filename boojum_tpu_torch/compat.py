"""Build the port's assembly and setup from plain arrays and ints.

The JAX package's `CSAssembly` and `SetupData` reduce to numpy arrays and
ints (placement, column values, gate names and order, public inputs, the
witness columns, sigma and constant columns, selector paths, non-residues
and, with lookups, the multiplicities and table stack, plus in specialized
mode the lookup placement and values and the table-id column). Feeding
those here gives the port the same circuit, so its prover can be held
against the JAX prover apart from synthesis. A gate is named, or, where
a name does not say all of it (a matrix, a width, a wrapped gate and its
budget, a set of constants), given as the JAX assembly's gate object, from
whose attributes `port_gate` rebuilds it. Nothing here imports the JAX
package.
"""

from __future__ import annotations

import numpy as np

from . import resolve_device
from .cs.gates import (
    GATES_BY_NAME,
    BoundedGateWrapper,
    ExplicitConstantsAllocatorGate,
    LookupMarkerGate,
    MatrixMultiplicationGate,
    UIntXAddGate,
)
from .cs.implementations import CSAssembly
from .cs.types import CSGeometry, LookupParameters
from .field.spec import SPECS
from .prover.setup import SetupData, commit_setup


def port_gate(gate, lookup_width: int = 0):
    """The port's gate for a gate name or a gate object (the JAX gate, read
    by its class name and parameter attributes); lookup_width: the lookup
    marker's width. A parametrised gate is rebuilt from its parameters and
    must come out with the same name and parameters, or this raises."""
    name = gate if isinstance(gate, str) else gate.name
    if name == LookupMarkerGate.name:
        return LookupMarkerGate.instance(
            lookup_width if isinstance(gate, str) else gate.principal_width)
    kind = None if isinstance(gate, str) else type(gate).__name__
    if kind in PARAMETRISED:
        ported, params = PARAMETRISED[kind](gate, lookup_width)
        for attr in params:
            if getattr(ported, attr) != getattr(gate, attr):
                raise ValueError(f"gate {name}: its {attr} does not carry over")
        if ported.name != name:
            raise ValueError(f"gate {name} rebuilt as {ported.name}")
        return ported
    if name not in GATES_BY_NAME:
        raise NotImplementedError(f"gate not ported: {name}")
    return GATES_BY_NAME[name].instance()


def _matrix_gate(gate, _lookup_width):
    if not gate.name.startswith("matmul_"):
        raise ValueError(f"matrix gate {gate.name} lacks the matmul_ prefix")
    return MatrixMultiplicationGate(gate.name[len("matmul_"):], gate.matrix), ("matrix",)


def _constants_gate(gate, _lookup_width):
    """The gate's own prime is its third constant plus one (-1 mod p)."""
    fields = {s.p: name for name, s in SPECS.items()}
    field = fields.get(int(gate.constants[2]) + 1)
    if field is None or list(gate.constants[:2]) != [0, 1]:
        raise ValueError(f"gate {gate.name}: its constants do not start with 0, 1 and "
                         f"p - 1 for a field's prime p")
    return ExplicitConstantsAllocatorGate(gate.constants[3:], field), ("constants",)


# the JAX class name of each parametrised gate: (its rebuild from the gate
# object, the attributes that must carry over unchanged)
PARAMETRISED = {
    "BoundedGateWrapper": lambda g, lw: (
        BoundedGateWrapper(port_gate(g.inner, lw), g.max_rows), ("max_rows",)),
    "MatrixMultiplicationGate": _matrix_gate,
    "UIntXAddGate": lambda g, _lw: (UIntXAddGate(g.width_bits), ("width_bits",)),
    "ExplicitConstantsAllocatorGate": _constants_gate,
}


def assembly_from_arrays(*, geometry, trace_len: int, gate_names, row_gate,
                         gate_constants, copy_placement, copy_values,
                         public_inputs, wit_placement=None, wit_values=None,
                         lookup_params=None, lookup_placement=None, lookup_values=None,
                         multiplicities=None, table_id_col=None,
                         table_stack=None) -> CSAssembly:
    """geometry: the four CSGeometry ints (copy, witness, constant columns,
    max degree); gate_names: each gate's name or object (`port_gate`);
    gate_constants: {row: tuple of ints}; public_inputs:
    [(column, row, value)]; wit_placement and wit_values (W, n) with witness
    columns. With lookups: lookup_params the four LookupParameters fields
    (width, repetitions, shared table id, specialized columns);
    multiplicities (n,); table_stack (width + 1, n), whose last row holds
    the table ids 1..T; in specialized mode also lookup_placement and
    lookup_values (R·width, n) and table_id_col (n,)."""
    geometry = CSGeometry(*(int(g) for g in geometry))
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

    return CSAssembly(
        geometry=geometry,
        trace_len=int(trace_len),
        gates=[port_gate(g, width) for g in gate_names],
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
