"""Synthesis-time constraint system and its frozen, provable assembly.

Same placement rules as the JAX package's cs/implementations/reference_cs.py
(era-boojum's CSReferenceImplementation): an instance goes into the open row
of its (gate, constants) key until the row holds num_repetitions instances;
`pad_and_shrink` completes partial rows with padding instances and rounds
the trace up to a power of two with NOP rows. Placement data is dense numpy
(column-major (cols, rows) place ids, -1 vacant).

Lookups use specialized columns (era-boojum lookup_placement.rs): every
enforced tuple is recorded, and at freeze the tuples are packed R to a row,
grouped by table, into R·width dedicated copy columns beside a table-id
column; vacant slots take a padding tuple (the table's row 0) whose
multiplicity is counted, so the log-derivative sums balance.

In general mode (era-boojum lookup_placement.rs:21) a tuple instead takes
one instance of the lookup-marker gate in the general copy columns, the
table id being that row's gate constant; a vacant instance takes the
table's row 0 and counts it.

Witness columns (places 2k + 1) hold values no copy constraint wires,
placed beside a gate's copy cells by `place_gate(..., wit_places=...)`.

The circuit is synthesized over a field (`field="goldilocks"` or
"babybear"): values and gate constants reduce modulo its prime, and the
assembly carries the field's name, on which setup and prove dispatch.

Difference: every value is resolved eagerly as a host int when its
variable is allocated, so there is no resolver.
"""

from __future__ import annotations

import numpy as np

from ...field.spec import spec_of
from ..gates.base import Gate
from ..gates.simple import ConstantsAllocatorGate, LookupMarkerGate, NopGate
from ..types import CSGeometry, LookupParameters


class FieldCapacityError(ValueError):
    """A gadget's arithmetic does not fit the circuit's field (raised at
    synthesis): sha256's u32 words need every 32-bit value to be a distinct
    field element, which BabyBear cannot give."""


class ConstraintSystem:
    def __init__(self, geometry: CSGeometry, max_trace_len: int,
                 lookup_params: LookupParameters | None = None,
                 field: str = "goldilocks"):
        self.field = field
        self.p = spec_of(field).p
        self.lookup_params = lookup_params or LookupParameters()
        self.geometry = geometry
        self.max_trace_len = max_trace_len
        self.values: list[int] = []  # value of variable k (place 2k)
        self.wit_values: list[int] = []  # value of witness k (place 2k + 1)
        c = geometry.num_columns_under_copy_permutation
        self.copy_placement = np.full((c, max_trace_len), -1, dtype=np.int64)
        self.wit_placement = np.full((geometry.num_witness_columns, max_trace_len), -1,
                                     dtype=np.int64)
        self.row_gate = np.full(max_trace_len, -1, dtype=np.int32)
        self.gates: list[Gate] = []
        self.gate_index: dict[str, int] = {}
        self.gate_constants: dict[int, tuple] = {}
        self.next_row = 0
        self._tooling: dict[tuple, list] = {}
        self.public_inputs: list[tuple[int, int]] = []
        self._constants_cache: dict[int, int] = {}
        self.trace_len = None
        self.lookup_tables: list = []
        self._table_by_name: dict[str, int] = {}
        self.lookup_rows: list[tuple[int, list[int]]] = []  # (table id, places)
        self.lookup_multiplicities: dict[tuple[int, int], int] = {}

    # -- allocation ---------------------------------------------------------

    def alloc_variable_with_value(self, value: int) -> int:
        self.values.append(int(value) % self.p)
        return (len(self.values) - 1) << 1

    def alloc_multiple_variables_without_values(self, n: int) -> list[int]:
        """n fresh variables, valued later by set_values_with_dependencies."""
        base = len(self.values)
        self.values.extend([0] * n)
        return [(base + i) << 1 for i in range(n)]

    def alloc_variable_without_value(self) -> int:
        return self.alloc_multiple_variables_without_values(1)[0]

    def alloc_witness_without_value(self) -> int:
        """A fresh witness-column place, valued later."""
        self.wit_values.append(0)
        return ((len(self.wit_values) - 1) << 1) | 1

    def _store(self, place: int):
        return self.wit_values if place & 1 else self.values

    def set_values_with_dependencies(self, ins, outs, fn):
        """Value `outs` as fn(values of `ins`), at once."""
        vals = fn([self.get_value(p) for p in ins])
        for p, v in zip(outs, vals):
            self._store(p)[p >> 1] = int(v) % self.p

    def get_value(self, place: int) -> int:
        return self._store(place)[place >> 1]

    def require_field_bits(self, bits: int, feature: str) -> None:
        """Raise FieldCapacityError unless every value below 2^bits is a
        distinct element of the circuit's field."""
        if (1 << bits) > self.p:
            raise FieldCapacityError(
                f"{feature} needs {bits}-bit values as single field elements, but "
                f"the circuit's field {self.field!r} has p = {self.p} (< 2^{bits}); "
                f"synthesize it over a larger field (field='goldilocks')"
            )

    def inv(self, v: int) -> int:
        """v^-1 in the circuit's field."""
        return pow(int(v), self.p - 2, self.p)

    def zero_var(self) -> int:
        return self.allocate_constant(0)

    def one_var(self) -> int:
        return self.allocate_constant(1)

    def allocate_constant(self, value: int) -> int:
        """A variable pinned to a constant; one per distinct value."""
        value = value % self.p
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

    def place_gate(self, gate: Gate, var_places, constants=(), wit_places=()):
        """Place one instance; returns (first_column, row) of the instance.
        A gate with witness columns takes its witness places in the
        instance's slot of the witness columns."""
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
                self.gate_constants[row] = tuple(int(c) % self.p for c in constants)
            tool = [row, 0]
            self._tooling[key] = tool
        row, used = tool
        off = used * gate.principal_width
        if len(var_places) != gate.principal_width:
            raise ValueError(f"gate {gate.name} takes {gate.principal_width} places")
        cp = self.copy_placement
        for i, p in enumerate(var_places):
            cp[off + i, row] = p
        if len(wit_places) != gate.witness_width:
            raise ValueError(f"gate {gate.name} takes {gate.witness_width} witness places")
        woff = used * gate.witness_width
        for i, p in enumerate(wit_places):
            self.wit_placement[woff + i, row] = p
        tool[1] = used + 1
        return off, row

    def set_public(self, column: int, row: int):
        self.public_inputs.append((column, row))

    # -- lookups ---------------------------------------------------------------

    def add_lookup_table(self, table) -> int:
        """Register a table; returns its id (ids start at 1)."""
        if table.name in self._table_by_name:
            raise ValueError(f"table {table.name} is already registered")
        self.lookup_tables.append(table)
        self._table_by_name[table.name] = len(self.lookup_tables)
        return len(self.lookup_tables)

    def ensure_table(self, name: str, make_table) -> int:
        """The id of table `name`, registering make_table() first if absent."""
        if name not in self._table_by_name:
            self.add_lookup_table(make_table())
        return self._table_by_name[name]

    def get_table_id(self, name: str) -> int:
        return self._table_by_name[name]

    def get_table(self, table_id: int):
        return self.lookup_tables[table_id - 1]

    def bump_multiplicity(self, table_id: int, row: int, times: int = 1):
        """Count `times` more uses of row `row` of the table."""
        key = (table_id, row)
        self.lookup_multiplicities[key] = self.lookup_multiplicities.get(key, 0) + times

    def enforce_lookup(self, table_id: int, keys: list[int]):
        """Constrain the tuple of places `keys` to be a row of the table and
        count that row's use. Tuples narrower than the argument are padded
        with the zero variable. In general mode the tuple is placed at once
        as a lookup-marker instance whose row constant is the table id."""
        params = self.lookup_params
        if not params.is_enabled:
            raise ValueError("lookups are not configured")
        table = self.get_table(table_id)
        if len(keys) != table.width or table.width > params.width:
            raise ValueError(f"table {table.name}: tuple of {len(keys)} places")
        keys = list(keys)
        while len(keys) < params.width:
            keys.append(self.zero_var())
        if params.use_specialized_columns:
            self.lookup_rows.append((table_id, keys))
        else:
            self.place_gate(LookupMarkerGate.instance(params.width), keys, (table_id,))
        self.bump_multiplicity(
            table_id, table.row_index([self.get_value(p) for p in keys[: table.width]]))

    def perform_lookup(self, table_id: int, key_places: list[int]) -> list[int]:
        """Allocate the table's values for the key variables and enforce."""
        table = self.get_table(table_id)
        outs = self.alloc_multiple_variables_without_values(table.num_values)
        self.set_values_with_dependencies(list(key_places), outs, table.lookup_values)
        self.enforce_lookup(table_id, list(key_places) + outs)
        return outs

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
        # rows the lookup columns need: R tuples a row, one table per row
        lookup_rows_needed = 0
        if self.lookup_rows:
            R = self.lookup_params.num_repetitions
            per_table: dict[int, int] = {}
            for tid, _ in self.lookup_rows:
                per_table[tid] = per_table.get(tid, 0) + 1
            lookup_rows_needed = sum((c + R - 1) // R for c in per_table.values())
        # the stacked table content must fit the trace too
        table_rows = sum(len(t) for t in self.lookup_tables)
        rows = max(self.next_row, lookup_rows_needed, table_rows, 1)
        n = 1 << max(3, (rows - 1).bit_length())
        if n > self.max_trace_len:
            raise ValueError(f"trace of {n} rows exceeds {self.max_trace_len}")
        nop_gid = self._register_gate(NopGate.instance())
        rg = self.row_gate[:n]
        rg[rg < 0] = nop_gid
        self.trace_len = n
        return n

    def _place_lookups(self, n: int):
        """Pack the recorded tuples into the specialized columns.

        Returns (placement (R·w, n) int64, table-id column (n,) uint64).
        Per table in id order, R tuples a row; a row's vacant slots, and
        every row after the last, take the table's padding tuple (fresh
        variables valued as its row 0; table 1 for the empty rows), and
        each padding slot adds one to the multiplicity of row 0."""
        R = self.lookup_params.num_repetitions
        w = self.lookup_params.width
        placement = np.full((R * w, n), -1, dtype=np.int64)
        table_id_col = np.zeros(n, dtype=np.uint64)
        pad_tuples: dict[int, list[int]] = {}

        def padding_tuple(tid: int) -> list[int]:
            tup = pad_tuples.get(tid)
            if tup is None:
                table = self.get_table(tid)
                row0 = [int(v) for v in table.content[0]] + [0] * (w - table.width)
                tup = self.alloc_multiple_variables_without_values(w)
                for p, v in zip(tup, row0):
                    self.values[p >> 1] = v
                pad_tuples[tid] = tup
            return tup

        by_table: dict[int, list[list[int]]] = {}
        for tid, places in self.lookup_rows:
            by_table.setdefault(tid, []).append(places)
        row = 0
        for tid in sorted(by_table):
            tuples = by_table[tid]
            for i in range(0, len(tuples), R):
                chunk = tuples[i : i + R]
                pad = R - len(chunk)
                if pad:
                    chunk = chunk + [padding_tuple(tid)] * pad
                    self.bump_multiplicity(tid, 0, pad)
                table_id_col[row] = tid
                for s, places in enumerate(chunk):
                    placement[s * w : (s + 1) * w, row] = places
                row += 1
        if row < n and self.lookup_tables:
            tup = np.array(padding_tuple(1), dtype=np.int64)
            table_id_col[row:] = 1
            for s in range(R):
                placement[s * w : (s + 1) * w, row:] = tup[:, None]
            self.bump_multiplicity(1, 0, (n - row) * R)
        return placement, table_id_col

    def into_assembly(self) -> "CSAssembly":
        n = self.trace_len or self.pad_and_shrink()
        lookups_on = self.lookup_params.is_enabled and bool(self.lookup_tables)
        if lookups_on and self.lookup_params.use_specialized_columns:
            lookup_placement, table_id_col = self._place_lookups(n)
        else:
            # general mode: the tuples sit in the general copy columns and
            # the table id is each marker row's gate constant
            lookup_placement = np.zeros((0, n), dtype=np.int64)
            table_id_col = None

        def scatter(placement, store):
            values = np.array(store or [0], dtype=np.uint64)
            cols = values[np.where(placement >= 0, placement >> 1, 0)]
            cols[placement < 0] = 0
            return cols

        placement = self.copy_placement[:, :n]
        wit_placement = self.wit_placement[:, :n]
        multiplicities = table_stack = None
        if lookups_on:
            offsets = np.cumsum([0] + [len(t) for t in self.lookup_tables])
            if offsets[-1] > n:
                raise ValueError("stacked lookup tables exceed the trace length")
            multiplicities = np.zeros(n, dtype=np.uint64)
            for (tid, row), cnt in self.lookup_multiplicities.items():
                multiplicities[offsets[tid - 1] + row] = cnt
            table_stack = stack_tables(self.lookup_tables, self.lookup_params.width, n)
        return CSAssembly(
            geometry=self.geometry,
            trace_len=n,
            gates=list(self.gates),
            row_gate=self.row_gate[:n].copy(),
            gate_constants=dict(self.gate_constants),
            copy_placement=placement.copy(),
            copy_cols_values=scatter(placement, self.values),
            wit_placement=wit_placement.copy(),
            wit_cols_values=scatter(wit_placement, self.wit_values),
            public_inputs=[
                (c, r, self.get_value(int(self.copy_placement[c, r])))
                for (c, r) in self.public_inputs
            ],
            lookup_params=self.lookup_params,
            lookup_placement=lookup_placement,
            lookup_cols_values=scatter(lookup_placement, self.values),
            lookup_table_id_col=table_id_col,
            multiplicities=multiplicities,
            table_stack=table_stack,
            num_lookup_tables=len(self.lookup_tables) if lookups_on else 0,
            field=self.field,
        )


def stack_tables(tables, width: int, n: int) -> np.ndarray:
    """(width + 1, n): the tables' columns zero-padded to `width`, then the
    table-id column, stacked over the tables in id order."""
    cols = np.zeros((width + 1, n), dtype=np.uint64)
    off = 0
    for tid, t in enumerate(tables, start=1):
        cols[: t.width, off : off + len(t)] = t.content.T
        cols[width, off : off + len(t)] = tid
        off += len(t)
    return cols


class CSAssembly:
    """Frozen, provable CS over `field`: placement, column values, gates,
    public inputs, the witness columns and, with lookups, the specialized
    columns (none in general mode), multiplicities and the stacked tables."""

    def __init__(self, *, geometry, trace_len, gates, row_gate, gate_constants,
                 copy_placement, copy_cols_values, public_inputs,
                 wit_placement=None, wit_cols_values=None,
                 lookup_params=None, lookup_placement=None, lookup_cols_values=None,
                 lookup_table_id_col=None, multiplicities=None, table_stack=None,
                 num_lookup_tables=0, field="goldilocks"):
        self.field = field
        self.geometry = geometry
        self.trace_len = trace_len
        self.gates = gates
        self.row_gate = row_gate
        self.gate_constants = gate_constants
        self.copy_placement = copy_placement
        self.copy_cols_values = copy_cols_values
        self.public_inputs = public_inputs
        if wit_placement is None:
            wit_placement = np.full((geometry.num_witness_columns, trace_len), -1,
                                    dtype=np.int64)
            wit_cols_values = np.zeros(wit_placement.shape, dtype=np.uint64)
        self.wit_placement = wit_placement
        self.wit_cols_values = wit_cols_values
        self.lookup_params = lookup_params or LookupParameters()
        if lookup_placement is None:
            lookup_placement = np.zeros((0, trace_len), dtype=np.int64)
            lookup_cols_values = np.zeros((0, trace_len), dtype=np.uint64)
        self.lookup_placement = lookup_placement
        self.lookup_cols_values = lookup_cols_values
        self.lookup_table_id_col = lookup_table_id_col
        self.multiplicities = multiplicities
        self.table_stack = table_stack
        self.num_lookup_tables = num_lookup_tables

    @property
    def num_copy_cols(self) -> int:
        """General-purpose copy columns (gates live here)."""
        return self.geometry.num_columns_under_copy_permutation

    @property
    def num_lookup_cols(self) -> int:
        """Specialized lookup copy columns, after the general ones."""
        return self.lookup_placement.shape[0]

    @property
    def num_copy_cols_total(self) -> int:
        return self.num_copy_cols + self.num_lookup_cols

    @property
    def num_wit_cols(self) -> int:
        return self.geometry.num_witness_columns

    @property
    def lookup_mode(self) -> str:
        """'none', 'specialized' or 'general'; general mode with no lookup
        placed has no marker gate and so no lookup argument."""
        if not self.lookup_params.is_enabled or not self.num_lookup_tables:
            return "none"
        if self.lookup_params.use_specialized_columns:
            return "specialized"
        return "general" if self.lookup_marker_gid() is not None else "none"

    @property
    def lookups_enabled(self) -> bool:
        return self.lookup_mode != "none"

    @property
    def num_lookup_subargs(self) -> int:
        """Sub-arguments: the configured repetitions in specialized mode,
        general copy columns // width in general mode."""
        mode = self.lookup_mode
        if mode == "specialized":
            return self.lookup_params.num_repetitions
        if mode == "general":
            return self.num_copy_cols // self.lookup_params.width
        return 0

    def lookup_marker_gid(self):
        """Index of the lookup-marker gate, or None."""
        return next((i for i, g in enumerate(self.gates) if g.is_lookup_marker), None)

    def stacked_table_columns(self, width: int) -> np.ndarray:
        """(width + 1, n) table setup columns (see stack_tables)."""
        if self.table_stack is None or self.table_stack.shape[0] != width + 1:
            raise ValueError(f"no stacked tables of width {width}")
        return self.table_stack
