"""Synthesis-time constraint system and its frozen, provable assembly.

Same placement rules as the JAX package's cs/implementations/reference_cs.py
(era-boojum's CSReferenceImplementation): an instance goes into the open row
of its (gate, constants) key until the row holds num_repetitions instances;
`pad_and_shrink` completes partial rows with padding instances and rounds
the trace up to a power of two with NOP rows. Placement data is dense numpy
(column-major (cols, rows) place ids, -1 vacant).

Differences: every value is resolved eagerly as a host int when its
variable is allocated, so there is no resolver; there are no lookups and no
witness columns (the fma-chain slice uses neither).
"""

from __future__ import annotations

import numpy as np

from ...field import gl
from ..gates.base import Gate
from ..gates.simple import ConstantsAllocatorGate, NopGate
from ..types import CSGeometry


class ConstraintSystem:
    def __init__(self, geometry: CSGeometry, max_trace_len: int):
        if geometry.num_witness_columns:
            raise NotImplementedError("witness columns are not ported yet")
        self.geometry = geometry
        self.max_trace_len = max_trace_len
        self.values: list[int] = []  # value of variable k
        c = geometry.num_columns_under_copy_permutation
        self.copy_placement = np.full((c, max_trace_len), -1, dtype=np.int64)
        self.row_gate = np.full(max_trace_len, -1, dtype=np.int32)
        self.gates: list[Gate] = []
        self.gate_index: dict[str, int] = {}
        self.gate_constants: dict[int, tuple] = {}
        self.next_row = 0
        self._tooling: dict[tuple, list] = {}
        self.public_inputs: list[tuple[int, int]] = []
        self._constants_cache: dict[int, int] = {}
        self.trace_len = None

    # -- allocation ---------------------------------------------------------

    def alloc_variable_with_value(self, value: int) -> int:
        self.values.append(int(value) % gl.P)
        return (len(self.values) - 1) << 1

    def get_value(self, place: int) -> int:
        return self.values[place >> 1]

    def zero_var(self) -> int:
        return self.allocate_constant(0)

    def allocate_constant(self, value: int) -> int:
        """A variable pinned to a constant; one per distinct value."""
        value = value % gl.P
        v = self._constants_cache.get(value)
        if v is None:
            v = ConstantsAllocatorGate.allocate_constant(self, value)
            self._constants_cache[value] = v
        return v

    # -- gate placement -----------------------------------------------------

    def _register_gate(self, gate: Gate) -> int:
        gid = self.gate_index.get(gate.name)
        if gid is None:
            if gate.num_constants > self.geometry.num_constant_columns:
                raise ValueError(f"gate {gate.name} needs more constant columns")
            gid = len(self.gates)
            self.gates.append(gate)
            self.gate_index[gate.name] = gid
        return gid

    def place_gate(self, gate: Gate, var_places, constants=()):
        """Place one instance; returns (first_column, row) of the instance."""
        gid = self._register_gate(gate)
        key = (gate.name, constants)
        tool = self._tooling.get(key)
        if tool is None or tool[1] >= gate.num_repetitions(self.geometry):
            row = self.next_row
            if row >= self.max_trace_len:
                raise ValueError("trace overflow")
            self.next_row += 1
            self.row_gate[row] = gid
            if constants:
                self.gate_constants[row] = tuple(int(c) % gl.P for c in constants)
            tool = [row, 0]
            self._tooling[key] = tool
        row, used = tool
        off = used * gate.principal_width
        if len(var_places) != gate.principal_width:
            raise ValueError(f"gate {gate.name} takes {gate.principal_width} places")
        cp = self.copy_placement
        for i, p in enumerate(var_places):
            cp[off + i, row] = p
        tool[1] = used + 1
        return off, row

    def set_public(self, column: int, row: int):
        self.public_inputs.append((column, row))

    # -- freeze -------------------------------------------------------------

    def pad_and_shrink(self) -> int:
        # padding may allocate helper constants (new constant rows), so
        # iterate to a fixpoint
        while True:
            unfinished = [
                (key, tool)
                for key, tool in self._tooling.items()
                if tool[1]
                < self.gates[self.gate_index[key[0]]].num_repetitions(self.geometry)
            ]
            if not unfinished:
                break
            for (gname, constants), tool in unfinished:
                gate = self.gates[self.gate_index[gname]]
                row, used = tool
                while used < gate.num_repetitions(self.geometry):
                    off = used * gate.principal_width
                    for i, p in enumerate(gate.padding_instance(self, constants)):
                        self.copy_placement[off + i, row] = p
                    used += 1
                tool[1] = used
        rows = max(self.next_row, 1)
        n = 1 << max(3, (rows - 1).bit_length())
        if n > self.max_trace_len:
            raise ValueError(f"trace of {n} rows exceeds {self.max_trace_len}")
        nop_gid = self._register_gate(NopGate.instance())
        rg = self.row_gate[:n]
        rg[rg < 0] = nop_gid
        self.trace_len = n
        return n

    def into_assembly(self) -> "CSAssembly":
        n = self.trace_len or self.pad_and_shrink()
        placement = self.copy_placement[:, :n]
        values = np.array(self.values, dtype=np.uint64)
        cols = values[np.where(placement >= 0, placement >> 1, 0)]
        cols[placement < 0] = 0
        return CSAssembly(
            geometry=self.geometry,
            trace_len=n,
            gates=list(self.gates),
            row_gate=self.row_gate[:n].copy(),
            gate_constants=dict(self.gate_constants),
            copy_placement=placement.copy(),
            copy_cols_values=cols,
            public_inputs=[
                (c, r, self.get_value(int(self.copy_placement[c, r])))
                for (c, r) in self.public_inputs
            ],
        )


class CSAssembly:
    """Frozen, provable CS: placement, witness columns, gates, public inputs."""

    def __init__(self, *, geometry, trace_len, gates, row_gate, gate_constants,
                 copy_placement, copy_cols_values, public_inputs):
        self.geometry = geometry
        self.trace_len = trace_len
        self.gates = gates
        self.row_gate = row_gate
        self.gate_constants = gate_constants
        self.copy_placement = copy_placement
        self.copy_cols_values = copy_cols_values
        self.public_inputs = public_inputs

    @property
    def num_copy_cols(self) -> int:
        return self.geometry.num_columns_under_copy_permutation
