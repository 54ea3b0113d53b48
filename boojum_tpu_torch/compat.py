"""Build the port's assembly and setup from plain arrays and ints.

The JAX package's `CSAssembly` and `SetupData` reduce to numpy arrays and
ints (placement, witness values, gate names and order, public inputs, sigma
and constant columns, selector paths, non-residues). Feeding those here
gives the port the same circuit, so its prover can be held against the JAX
prover apart from synthesis. Nothing here imports the JAX package.
"""

from __future__ import annotations

import numpy as np

from . import resolve_device
from .cs.gates import GATES_BY_NAME
from .cs.implementations import CSAssembly
from .cs.types import CSGeometry
from .prover.setup import SetupData, commit_setup


def assembly_from_arrays(*, geometry, trace_len: int, gate_names, row_gate,
                         gate_constants, copy_placement, copy_values,
                         public_inputs) -> CSAssembly:
    """geometry: the four CSGeometry ints (copy, witness, constant columns,
    max degree); gate_constants: {row: tuple of ints}; public_inputs:
    [(column, row, value)]."""
    geometry = CSGeometry(*(int(g) for g in geometry))
    unknown = [g for g in gate_names if g not in GATES_BY_NAME]
    if unknown:
        raise NotImplementedError(f"gates not ported: {unknown}")
    return CSAssembly(
        geometry=geometry,
        trace_len=int(trace_len),
        gates=[GATES_BY_NAME[g].instance() for g in gate_names],
        row_gate=np.asarray(row_gate, dtype=np.int32).copy(),
        gate_constants={
            int(r): tuple(int(c) for c in cs) for r, cs in gate_constants.items()
        },
        copy_placement=np.asarray(copy_placement, dtype=np.int64).copy(),
        copy_cols_values=np.asarray(copy_values, dtype=np.uint64).copy(),
        public_inputs=[(int(c), int(r), int(v)) for (c, r, v) in public_inputs],
    )


def setup_from_arrays(assembly: CSAssembly, config, *, sigma_cols, constant_cols,
                      selector_paths, non_residues, quotient_degree: int,
                      device="cuda") -> SetupData:
    """Commit given setup columns on the device and build the VK."""
    return commit_setup(
        assembly, config,
        np.asarray(sigma_cols, dtype=np.uint64),
        np.asarray(constant_cols, dtype=np.uint64),
        [[int(b) for b in p] for p in selector_paths],
        [int(k) for k in non_residues],
        int(quotient_degree),
        resolve_device(device),
    )
