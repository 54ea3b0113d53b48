"""Witness resolution: the dataflow engine behind the constraint system.

The JAX package's dag/resolver.py (era-boojum's resolvers, src/dag/): a
resolution is fn(values of `ins`) -> values of `outs`. It runs at once when
its inputs are known, the common case, as gadget code computes forward;
otherwise it is parked on its missing inputs and the input that arrives last
fires it. Every value of a system lives in one arena of places, variable k
at 2k and witness k at 2k + 1.

Storage: the arena is a numpy uint64 array (`values`) with a uint8 state a
place (`state`: 0 unset, 1 resolved, 2 pending on the native tape, over a
bytearray). Python reads and writes the values through a memoryview and the
states through the bytearray, without numpy scalars; the native engine
writes both in place, so nothing is mirrored or copied at a flush.

Resolvers: `WitnessResolver` (Python closures), `NativeTapeResolver` (the
C++ tape of `..native` for ops with a typed descriptor, Goldilocks only),
`PlaybackResolver` (a recorded order, replayed), `NullResolver` (setup-only
synthesis: stores nothing). `make_resolver(field)` picks the tape over
Goldilocks and the Python resolver over any other field.
"""

from __future__ import annotations

import numpy as np

from ..field.spec import spec_of
from ..native import OP_CONST, OP_FMA, OP_NAMES, OP_REDUCTION

UNSET, RESOLVED, PENDING = 0, 1, 2


class WitnessResolver:
    name = "python"
    # typed ops that a native engine runs on its tape: none here, every
    # closure runs in Python
    TAPE_OPS: frozenset = frozenset()

    def __init__(self, capacity: int = 1 << 16, p: int | None = None):
        self.p = p if p is not None else spec_of("goldilocks").p
        self.values = np.zeros(0, dtype=np.uint64)
        self.state = np.zeros(0, dtype=np.uint8)
        self._realloc(max(int(capacity), 1))
        # place -> resolutions parked on it: [missing count, ins, outs, fn, id]
        self._waiters: dict[int, list] = {}
        self._num_pending = 0
        # record / playback (era-boojum mt/sorters/): with recording on,
        # every registered resolution takes a sequential id and the record
        # lists the ids in the order they ran
        self._record: list[int] | None = None
        self._reg_counter = 0

    # -- record / playback ------------------------------------------------------

    def start_recording(self):
        """Record the order in which resolutions run, for a playback."""
        assert self._reg_counter == 0, "recording must start before synthesis"
        self._record = []

    def resolution_record(self) -> list[int]:
        assert self._record is not None, "recording was not enabled"
        return list(self._record)

    # -- storage ----------------------------------------------------------------

    def _realloc(self, cap: int):
        n = len(self.values)
        values = np.zeros(cap, dtype=np.uint64)
        values[:n] = self.values
        # Python reads the states through the bytearray, the engine and
        # numpy through the array over the same bytes
        st = bytearray(cap)
        state = np.frombuffer(st, dtype=np.uint8)
        state[:n] = self.state
        self.values, self.state = values, state
        self._val = memoryview(values)
        self._st = st
        self._cap = cap

    def _ensure(self, idx: int):
        if idx >= self._cap:
            self._realloc(max(2 * self._cap, idx + 1))

    def is_resolved(self, place: int) -> bool:
        return place < self._cap and self._st[place] == RESOLVED

    def get_value(self, place: int) -> int:
        if place < self._cap and self._st[place] == RESOLVED:
            return self._val[place]
        raise AssertionError(f"place {place} unresolved")

    def set_value(self, place: int, value: int):
        if place >= self._cap:
            self._ensure(place)
        assert not self._st[place], f"place {place} set twice"
        self._val[place] = value
        self._st[place] = RESOLVED
        if self._waiters and place in self._waiters:
            self._wake(place)

    def _wake(self, place: int):
        for rec in self._waiters.pop(place):
            rec[0] -= 1
            if rec[0] == 0:
                self._num_pending -= 1
                if self._record is not None:
                    self._record.append(rec[4])
                self._run(rec[1], rec[2], rec[3])

    # -- resolutions ------------------------------------------------------------

    def add_resolution(self, ins, outs, fn, native=None, table=None):
        """Register fn(list of input ints) -> list of output ints; it runs at
        once when every input is resolved. `native` (a typed-op descriptor)
        and `table` are for a native tape, which takes the ops of TAPE_OPS
        and any typed op without a closure (`fn` None)."""
        reg_id = self._reg_counter
        self._reg_counter = reg_id + 1
        if native is not None and (native[0] in self.TAPE_OPS or fn is None):
            self._defer(ins, outs, fn, reg_id, native, table)
            return
        val, st = self._val, self._st
        try:
            vals = [val[p] for p in ins if st[p] == RESOLVED]
        except IndexError:
            vals = ()
        if len(vals) != len(ins):
            self._defer(ins, outs, fn, reg_id, native, table)
            return
        if self._record is not None:
            self._record.append(reg_id)
        out_vals = fn(vals)
        # `_write`'s work for one output in the arena, inlined: 3-6% of an
        # fma chain's synthesis
        if len(outs) == 1 and len(out_vals) == 1:
            q = outs[0]
            if q < self._cap and not st[q]:
                val[q] = out_vals[0] % self.p
                st[q] = RESOLVED
                if self._waiters and q in self._waiters:
                    self._wake(q)
                return
        if outs or out_vals:  # none for a lookup's counter
            self._write(outs, out_vals)

    def _defer(self, ins, outs, fn, reg_id, native, table):
        """A resolution that did not run at once: parked on its missing
        inputs, or run if none is missing."""
        missing = [p for p in ins if not self.is_resolved(p)]
        if not missing:
            if self._record is not None:
                self._record.append(reg_id)
            self._run(ins, outs, fn)
            return
        rec = [len(missing), ins, outs, fn, reg_id]
        self._num_pending += 1
        for p in missing:
            self._waiters.setdefault(p, []).append(rec)

    def _run(self, ins, outs, fn):
        val = self._val
        self._write(outs, fn([val[p] for p in ins]))

    def _write(self, outs, out_vals):
        """Store a resolution's outputs (reduced modulo p) and wake what
        waits on them."""
        if len(out_vals) != len(outs):
            raise AssertionError("resolver arity mismatch")
        val, st, p = self._val, self._st, self.p
        i = 0  # an index, not zip: a builtin call costs more than the loop
        try:
            for q in outs:
                if st[q]:
                    raise AssertionError(f"place {q} set twice")
                val[q] = out_vals[i] % p
                st[q] = RESOLVED
                i += 1
        except IndexError:
            # outs[i] lies past the arena: the ones before it are stored
            self._ensure(max(outs))
            self._write(outs[i:], out_vals[i:])
            return
        if self._waiters:
            for q in outs:
                if q in self._waiters:
                    self._wake(q)

    def native_multiplicities(self, table_id: int):
        """Lookup counts kept by a native engine (none here)."""
        return None

    def wait_till_resolved(self):
        """Every registered resolution must have run."""
        if self._num_pending:
            unresolved = [p for p, w in self._waiters.items() if w]
            raise RuntimeError(
                f"{self._num_pending} witness resolutions never fired; "
                f"first unresolved places: {unresolved[:10]}")

    # -- bulk views ---------------------------------------------------------------

    def values_flat(self, count: int) -> np.ndarray:
        """Values of places [0, count), every one resolved."""
        self._ensure(count - 1)
        assert (self.state[:count] == RESOLVED).all(), "unresolved places in flat dump"
        return self.values[:count]

    def arena(self, count: int) -> np.ndarray:
        """A copy of the values of places [0, count); unset places read 0."""
        out = np.zeros(count, dtype=np.uint64)
        n = min(count, self._cap)
        out[:n] = self.values[:n]
        return out


class NativeTapeResolver(WitnessResolver):
    """Resolutions with a typed descriptor go on the C++ tape, once every
    input is resolved or itself pending on the tape; the rest run as Python
    closures, and so do the scalar ops (const, fma, reduction) whose inputs
    are all resolved. The tape runs lazily: when a pending place is read, when a
    Python closure needs one, and at `wait_till_resolved`. A batch that
    reaches ASYNC_THRESHOLD ops runs on a worker thread while synthesis goes
    on (the ctypes call releases the GIL); a smaller one runs on the calling
    thread, after every batch in flight. The engine marks each output
    resolved as it writes it. Lookup counts of the tape's OP_LOOKUP_BUMP ops
    stay in the engine (`native_multiplicities`).

    Over Goldilocks only: the engine's arithmetic is hardwired to it."""

    name = "native"
    ASYNC_THRESHOLD = 8192
    # a few multiplications cost less run at once than appended to the tape:
    # those ops go there only when an input is pending on it
    TAPE_OPS = frozenset(OP_NAMES) - {OP_CONST, OP_FMA, OP_REDUCTION}

    def __init__(self, lib, capacity: int = 1 << 16):
        super().__init__(capacity=capacity, p=spec_of("goldilocks").p)
        from ..native import NativeTape

        self._tape = NativeTape(lib)
        self._poison: Exception | None = None
        self._executor = None
        self._inflight: list = []  # futures, in submission order

    def _ensure(self, idx: int):
        # a batch in flight writes into `values` and `state` at the addresses
        # it was given: reallocating under it would strand its writes
        if idx >= self._cap and self._inflight:
            self._join()
        super()._ensure(idx)

    # -- batches ------------------------------------------------------------------

    def flush_async(self):
        """Detach the tape's batch and run it on the worker thread. Batches
        run in order on one worker, so a later one sees what an earlier
        one wrote."""
        snap = self._tape.take_snapshot()
        if snap is None:
            return
        if self._executor is None:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(max_workers=1,
                                                thread_name_prefix="boojum-tape")
        self._inflight.append(self._executor.submit(
            self._tape.run_snapshot, self.values.ctypes.data, self.state.ctypes.data, snap))

    def _join(self):
        """Wait for every batch in flight; the first failure poisons."""
        inflight, self._inflight = self._inflight, []
        first = None
        for fut in inflight:
            try:
                fut.result()
            except RuntimeError as e:
                first = first or e
        if first is not None:
            self._fail(first)
            raise first

    def _fail(self, e: Exception):
        # a failed batch cannot run again (its earlier ops did run): every
        # later read names this error instead of an unresolved place
        self._poison = e
        self._tape.take_snapshot()

    def flush(self):
        if self._inflight:
            self._join()
        snap = self._tape.take_snapshot()
        if snap is not None:
            try:
                self._tape.run_snapshot(self.values.ctypes.data, self.state.ctypes.data,
                                        snap)
            except RuntimeError as e:
                self._fail(e)
                raise
        # wake Python closures parked on places the tape resolved
        if self._waiters:
            st = self._st
            for p in [p for p in self._waiters if p < self._cap and st[p] == RESOLVED]:
                if p in self._waiters:
                    self._wake(p)

    def _check_poison(self):
        if self._poison is not None:
            raise RuntimeError(
                "witness resolution incomplete because an earlier native "
                "resolution batch failed") from self._poison

    def wait_till_resolved(self):
        self.flush()
        self._check_poison()
        super().wait_till_resolved()

    def values_flat(self, count: int) -> np.ndarray:
        self.flush()
        self._check_poison()
        return super().values_flat(count)

    def arena(self, count: int) -> np.ndarray:
        self.flush()
        self._check_poison()
        return super().arena(count)

    def is_resolved(self, place: int) -> bool:
        if place >= self._cap:
            return False
        if self._st[place] == PENDING and self._poison is None:
            self.flush()
        return self._st[place] == RESOLVED

    def get_value(self, place: int) -> int:
        if place < self._cap:
            s = self._st[place]
            if s == RESOLVED:
                return self._val[place]
            if s == PENDING:
                if self._poison is None:
                    self.flush()
                if self._st[place] == RESOLVED:
                    return self._val[place]
        self._check_poison()
        raise AssertionError(f"place {place} unresolved")

    def set_value(self, place: int, value: int):
        if place < self._cap and self._st[place] == PENDING:
            raise AssertionError(f"place {place} set twice")
        super().set_value(place, value)

    # -- resolutions --------------------------------------------------------------

    def _defer(self, ins, outs, fn, reg_id, native, table):
        # a tape op, or an input not resolved: unset, or pending on the tape
        st = self._st
        unset = pending = False
        try:
            for p in ins:
                s = st[p]
                if s != RESOLVED:
                    if s:
                        pending = True
                    else:
                        unset = True
        except IndexError:
            unset = True
        if native is not None and not unset:
            # tape ops run in append order: log them now
            if self._record is not None:
                self._record.append(reg_id)
            kind, params = native
            tape = self._tape
            if table is not None:
                slot = tape.slot.get(params[0])
                if slot is None:
                    if self._inflight:
                        self._join()
                    slot = tape.ensure_table(params[0], table)
                params = (slot,)
            if outs:
                try:
                    for q in outs:
                        if st[q]:
                            raise AssertionError(f"place {q} set twice")
                        st[q] = PENDING
                except IndexError:
                    for q in outs:
                        if q < self._cap and st[q] == PENDING:
                            st[q] = UNSET
                    self._ensure(max(outs))
                    st = self._st
                    for q in outs:
                        st[q] = PENDING
            tape.stream.extend((kind, len(params), *params, len(ins), *ins, len(outs), *outs))
            tape.num_ops += 1
            if tape.num_ops >= self.ASYNC_THRESHOLD:
                self.flush_async()
            return
        if pending:
            self.flush()
            self._check_poison()
        super()._defer(ins, outs, fn, reg_id, native, table)

    def native_multiplicities(self, table_id: int):
        # the engine counts as its batches run: run them all first
        self.flush()
        self._check_poison()
        return self._tape.multiplicities_of(table_id)


class PlaybackResolver(WitnessResolver):
    """Re-runs a recorded synthesis (era-boojum mt/sorters/sorter_playback.rs):
    resolutions run in exactly the recorded order with no dependency
    tracking. Each one's inputs must be resolved when its turn comes, or the
    synthesis diverged from the recorded run and playback raises."""

    name = "playback"

    def __init__(self, record, capacity: int = 1 << 16, p: int | None = None):
        super().__init__(capacity=capacity, p=p)
        self._playback = list(record)
        self._cursor = 0
        self._parked: dict[int, tuple] = {}

    def _drain(self):
        while (self._cursor < len(self._playback)
               and self._playback[self._cursor] in self._parked):
            nid = self._playback[self._cursor]
            self._cursor += 1
            pins, pouts, pfn = self._parked.pop(nid)
            for p in pins:
                if not self.is_resolved(p):
                    raise RuntimeError(
                        f"playback divergence: resolution {nid} input {p} "
                        "not resolved at its recorded slot")
            self._run(pins, pouts, pfn)

    def add_resolution(self, ins, outs, fn, native=None, table=None):
        assert fn is not None, "playback needs the Python closure"
        reg_id = self._reg_counter
        self._reg_counter += 1
        self._parked[reg_id] = (ins, outs, fn)
        self._drain()

    def get_value(self, place: int) -> int:
        if not self.is_resolved(place):
            self._drain()
        return super().get_value(place)

    def wait_till_resolved(self):
        if self._cursor != len(self._playback) or self._parked:
            raise RuntimeError(
                "playback divergence: "
                f"{len(self._playback) - self._cursor} recorded resolutions "
                f"never ran, {len(self._parked)} registrations unmatched")


class NullResolver(WitnessResolver):
    """Setup-only synthesis (era-boojum NullCircuitResolver,
    dag/resolvers/null.rs): accepts registrations and stores nothing."""

    name = "null"

    def __init__(self, p: int | None = None):
        super().__init__(capacity=1, p=p)

    def set_value(self, place: int, value: int):
        pass

    def add_resolution(self, ins, outs, fn, native=None, table=None):
        pass

    def is_resolved(self, place: int) -> bool:
        return False

    def wait_till_resolved(self):
        pass


def make_resolver(field: str = "goldilocks", capacity: int = 1 << 16) -> WitnessResolver:
    """The default resolver of a system over `field`: the native tape over
    Goldilocks (building the engine at first use; raises without a
    compiler), the Python resolver over any other field, whose closures
    reduce modulo its prime."""
    if field != "goldilocks":
        return WitnessResolver(capacity=capacity, p=spec_of(field).p)
    from ..native import get_lib

    return NativeTapeResolver(get_lib(), capacity=capacity)
