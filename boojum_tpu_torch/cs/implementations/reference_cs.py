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

Values live in a witness resolver (`..dag`): a gadget registers a closure
`fn(values of ins) -> values of outs`, with a typed descriptor (`native=`)
where the JAX package gives one. By default the native tape resolves over
Goldilocks and the Python resolver over BabyBear (`make_resolver`); a
caller may pass its own (`resolver=`). Under SETUP_CS_CONFIG the resolver
is the NullResolver: the placement is built without a witness, and an
assembly of the same circuit from any witness takes it over by
`CSAssembly.with_external_witness`.
"""

from __future__ import annotations

import copy

import numpy as np

from ...dag import NullResolver, make_resolver
from ...field.spec import spec_of
from ...native import OP_LOOKUP, OP_LOOKUP_BUMP
from ..gates.base import Gate
from ..gates.simple import ConstantsAllocatorGate, LookupMarkerGate, NopGate
from ..types import DEV_CS_CONFIG, CSConfig, CSGeometry, LookupParameters


class FieldCapacityError(ValueError):
    """A gadget's arithmetic does not fit the circuit's field (raised at
    synthesis): sha256's u32 words need every 32-bit value to be a distinct
    field element, which BabyBear cannot give."""


class ConstraintSystem:
    def __init__(self, geometry: CSGeometry, max_trace_len: int,
                 config: CSConfig = DEV_CS_CONFIG,
                 lookup_params: LookupParameters | None = None,
                 resolver=None, field: str = "goldilocks"):
        self.field = field
        self.p = spec_of(field).p
        self.config = config
        self.lookup_params = lookup_params or LookupParameters()
        self.geometry = geometry
        self.max_trace_len = max_trace_len
        if resolver is None:
            resolver = (make_resolver(field) if config.evaluate_witness
                        else NullResolver(p=self.p))
        elif resolver.p != self.p:
            raise ValueError(f"resolver over p = {resolver.p}, circuit over {field}")
        self.resolver = resolver
        # synthesis's hottest call, bound once: the method below documents it
        self.set_values_with_dependencies = resolver.add_resolution
        self.next_var_idx = 0
        self.next_wit_idx = 0
        c = geometry.num_columns_under_copy_permutation
        self.copy_placement = np.full((c, max_trace_len), -1, dtype=np.int64)
        self.wit_placement = np.full((geometry.num_witness_columns, max_trace_len), -1,
                                     dtype=np.int64)
        self._copy_cells = memoryview(self.copy_placement.reshape(-1))
        self._wit_cells = memoryview(self.wit_placement.reshape(-1))
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
        self._bumps: dict = {}  # table id -> (closure, descriptor) of its counter

    # -- allocation ---------------------------------------------------------

    def alloc_variable_with_value(self, value: int) -> int:
        place = self.next_var_idx << 1
        self.next_var_idx += 1
        self.resolver.set_value(place, int(value) % self.p)
        return place

    def alloc_multiple_variables_without_values(self, n: int) -> list[int]:
        """n fresh variables, valued later by set_values_with_dependencies."""
        base = self.next_var_idx
        self.next_var_idx = base + n
        return [(base + i) << 1 for i in range(n)]

    def alloc_variable_without_value(self) -> int:
        place = self.next_var_idx << 1
        self.next_var_idx += 1
        return place

    def alloc_witness_without_value(self) -> int:
        """A fresh witness-column place, valued later."""
        place = (self.next_wit_idx << 1) | 1
        self.next_wit_idx += 1
        return place

    def set_values_with_dependencies(self, ins, outs, fn, native=None, table=None):
        """Value `outs` as fn(values of `ins`) once the inputs are known.
        `native` is the typed-op descriptor (op id, params) of the native
        tape, `table` the lookup table an op reads; `fn` is the portable
        form every resolver can run."""
        self.resolver.add_resolution(ins, outs, fn, native, table)

    def get_value(self, place: int) -> int:
        return self.resolver.get_value(place)

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
        key = (gate.name, constants)
        tool = self._tooling.get(key)
        if tool is None or tool[1] >= tool[2]:
            gid = self._register_gate(gate)
            row = self.next_row
            if row >= self.max_trace_len:
                raise ValueError("trace overflow")
            self.next_row += 1
            self.row_gate[row] = gid
            if constants:
                self.gate_constants[row] = tuple(int(c) % self.p for c in constants)
            # [row, instances placed, instances a row, widths of an instance]
            tool = [row, 0, gate.num_repetitions(self.geometry), gate.principal_width,
                    gate.witness_width]
            self._tooling[key] = tool
        row, used, _, width, wit_width = tool
        off = used * width
        if len(var_places) != width:
            raise ValueError(f"gate {gate.name} takes {width} places")
        # the placements' cells through flat views: column c, row r at c·L + r
        L = self.max_trace_len
        cell = self._copy_cells
        at = off * L + row
        for p in var_places:
            cell[at] = p
            at += L
        if len(wit_places) != wit_width:
            raise ValueError(f"gate {gate.name} takes {wit_width} witness places")
        if wit_places:
            cell = self._wit_cells
            at = used * wit_width * L + row
            for p in wit_places:
                cell[at] = p
                at += L
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
        """Count `times` more uses of row `row` of the table (nothing
        without a witness)."""
        if not self.config.evaluate_witness:
            return
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
        table = self.lookup_tables[table_id - 1]
        width = table.width
        if len(keys) != width or width > params.width:
            raise ValueError(f"table {table.name}: tuple of {len(keys)} places")
        keys = list(keys)
        if width < params.width:
            keys += [self.zero_var()] * (params.width - width)
        if params.use_specialized_columns:
            self.lookup_rows.append((table_id, keys))
        else:
            self.place_gate(LookupMarkerGate.instance(params.width), keys, (table_id,))
        if self.config.evaluate_witness:
            bump = self._bumps.get(table_id)
            if bump is None:
                bump = self._bumps[table_id] = (self._bump_fn(table_id),
                                                (OP_LOOKUP_BUMP, (table_id,)))
            self.resolver.add_resolution(keys[:width], (), *bump, table)

    def _bump_fn(self, table_id: int):
        """The closure that counts a resolved tuple's row of a table."""
        table, counts = self.get_table(table_id), self.lookup_multiplicities

        def bump(vals):
            key = (table_id, table.row_index(vals))
            counts[key] = counts.get(key, 0) + 1
            return ()

        return bump

    def perform_lookup(self, table_id: int, key_places: list[int]) -> list[int]:
        """Allocate the table's values for the key variables and enforce."""
        table = self.lookup_tables[table_id - 1]
        outs = self.alloc_multiple_variables_without_values(table.num_values)
        key_places = list(key_places)
        self.resolver.add_resolution(key_places, outs, table.lookup_values,
                                     (OP_LOOKUP, (table_id,)), table)
        self.enforce_lookup(table_id, key_places + outs)
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
                row, used = tool[0], tool[1]
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
                    self.resolver.set_value(p, v)
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
        # after padding and lookup placement, which both register values:
        # every resolution, the native tape's too, must have run
        self.resolver.wait_till_resolved()
        arena = self.resolver.arena(2 * max(self.next_var_idx, self.next_wit_idx) + 2)
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
            if self.config.evaluate_witness:
                # the native tape's counts, merged
                for tid in range(1, len(self.lookup_tables) + 1):
                    nm = self.resolver.native_multiplicities(tid)
                    if nm is not None:
                        multiplicities[offsets[tid - 1]:offsets[tid]] += nm.astype(np.uint64)
            table_stack = stack_tables(self.lookup_tables, self.lookup_params.width, n)
        if self.config.evaluate_witness:
            public_inputs = [(c, r, int(arena[self.copy_placement[c, r]]))
                             for (c, r) in self.public_inputs]
        else:
            public_inputs = [(c, r, 0) for (c, r) in self.public_inputs]
        return CSAssembly(
            geometry=self.geometry,
            trace_len=n,
            gates=list(self.gates),
            row_gate=self.row_gate[:n].copy(),
            gate_constants=dict(self.gate_constants),
            copy_placement=placement.copy(),
            copy_cols_values=scatter(placement, arena),
            wit_placement=wit_placement.copy(),
            wit_cols_values=scatter(wit_placement, arena),
            public_inputs=public_inputs,
            lookup_params=self.lookup_params,
            lookup_placement=lookup_placement,
            lookup_cols_values=scatter(lookup_placement, arena),
            lookup_table_id_col=table_id_col,
            multiplicities=multiplicities,
            table_stack=table_stack,
            num_lookup_tables=len(self.lookup_tables) if lookups_on else 0,
            field=self.field,
            lookup_tables=list(self.lookup_tables),
            resolver=self.resolver,
        )


def scatter(placement: np.ndarray, arena: np.ndarray) -> np.ndarray:
    """The values of a placement's places; vacant cells (-1) read 0."""
    cols = arena[np.where(placement >= 0, placement, 0)]
    cols[placement < 0] = 0
    return cols


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
    columns (none in general mode), multiplicities and the stacked tables.
    An assembly from synthesis keeps its tables and its resolver, whose
    arena `witness_vec` returns; pickling drops the resolver."""

    def __init__(self, *, geometry, trace_len, gates, row_gate, gate_constants,
                 copy_placement, copy_cols_values, public_inputs,
                 wit_placement=None, wit_cols_values=None,
                 lookup_params=None, lookup_placement=None, lookup_cols_values=None,
                 lookup_table_id_col=None, multiplicities=None, table_stack=None,
                 num_lookup_tables=0, field="goldilocks", lookup_tables=None,
                 resolver=None):
        self.field = field
        self.lookup_tables = lookup_tables
        self.resolver = resolver
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

    def __getstate__(self):
        # the resolver holds the native engine's handles; the columns carry
        # everything a proof needs
        state = dict(self.__dict__)
        state["resolver"] = None
        return state

    def witness_vec(self) -> np.ndarray:
        """The resolver's arena over every placed place (era-boojum
        WitnessVec, witness.rs): the witness of this circuit as one vector,
        which `with_external_witness` takes back."""
        if self.resolver is None:
            raise RuntimeError(
                "witness_vec() needs the live resolver, which a pickled assembly "
                "drops: call it before pickling and carry the vector alongside")
        count = int(max(self.copy_placement.max(initial=-1),
                        self.wit_placement.max(initial=-1),
                        self.lookup_placement.max(initial=-1)) + 1)
        return self.resolver.arena(count)

    def with_external_witness(self, witness_vec) -> "CSAssembly":
        """The same circuit over another witness (era-boojum
        into_assembly_for_repeated_proving, reference_cs.rs): the columns
        are gathered from the vector and the lookup multiplicities counted
        again from the placed tuples. The setup of this assembly proves it."""
        arena = np.asarray(witness_vec, dtype=np.uint64)
        copy_cols = scatter(self.copy_placement, arena)
        mode = self.lookup_mode
        multiplicities = self.multiplicities
        if mode != "none":
            if self.lookup_tables is None:
                raise ValueError("recounting lookups needs the assembly's tables")
            w = self.lookup_params.width
            if mode == "general":
                gid = self.lookup_marker_gid()
                reps = self.gates[gid].num_repetitions(self.geometry)
                rows = np.nonzero(self.row_gate == gid)[0]
                tids = np.array([self.gate_constants[int(r)][0] for r in rows],
                                dtype=np.uint64)
                cols = copy_cols[:, rows]
            else:
                reps = self.lookup_params.num_repetitions
                tids = np.asarray(self.lookup_table_id_col, dtype=np.uint64)
                cols = scatter(self.lookup_placement, arena)
            multiplicities = self._count_lookups(tids, cols, reps, w)
        new = copy.copy(self)
        new.resolver = None  # its arena holds the other witness
        new.copy_cols_values = copy_cols
        new.wit_cols_values = scatter(self.wit_placement, arena)
        new.lookup_cols_values = scatter(self.lookup_placement, arena)
        new.multiplicities = multiplicities
        new.public_inputs = [(c, r, int(arena[self.copy_placement[c, r]]))
                             for (c, r, _v) in self.public_inputs]
        return new

    def _count_lookups(self, tids, cols, reps: int, w: int) -> np.ndarray:
        """Multiplicities over the stacked tables of the tuples in `cols`
        ((reps·w, rows), the row's table id in `tids`)."""
        offsets = np.cumsum([0] + [len(t) for t in self.lookup_tables])
        out = np.zeros(self.trace_len, dtype=np.uint64)
        for tid in np.unique(tids):
            if tid == 0:
                raise ValueError("a lookup row with table id 0")
            table, at = self.lookup_tables[int(tid) - 1], tids == tid
            for s in range(reps):
                rows = table.rows_of(cols[s * w: s * w + table.width, at])
                out += np.bincount(offsets[int(tid) - 1] + rows,
                                   minlength=self.trace_len).astype(np.uint64)
        return out
