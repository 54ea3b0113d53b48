"""The native witness-resolution engine: build, load and the tape.

`resolver.cpp` (the port's own copy of the JAX package's engine) is compiled
with g++ at first use, never at import, into `_build/` beside the package
(git-ignored), under a file name that hashes the source, the compiler and
its flags: an edited source is rebuilt, an unchanged one loaded as it is.
Without a working compiler `get_lib` raises with the compiler's name and
its stderr; nothing falls back.

The tape is one `array.array` stream of words that the engine reads in
place (kind, n_params, params, n_in, ins, n_out, outs an op), so a flush
copies nothing; the engine writes the values into the resolver's arena and
marks each output in its state bytes. Lookup tables live in process-global
slots: each constraint system's tables get fresh slots, so several systems
in one process never share multiplicity counters. Every call into the
engine holds `ENGINE_LOCK`, since a table registration may move the table
vector a running batch reads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from array import array
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "resolver.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

OP_CONST = 0
OP_FMA = 1
OP_REDUCTION = 2
OP_SPLIT = 3
OP_U32_ADD = 4
OP_U32_SUB = 5
OP_TRIADD = 6
OP_U32_FMA = 7
OP_BYTE_TRIADD = 8
OP_POSEIDON2 = 9
OP_LOOKUP = 10
OP_LOOKUP_BUMP = 11

OP_NAMES = {
    OP_CONST: "const", OP_FMA: "fma", OP_REDUCTION: "reduction", OP_SPLIT: "split",
    OP_U32_ADD: "u32_add", OP_U32_SUB: "u32_sub", OP_TRIADD: "tri_add",
    OP_U32_FMA: "u32_fma", OP_BYTE_TRIADD: "byte_tri_add", OP_POSEIDON2: "poseidon2",
    OP_LOOKUP: "lookup", OP_LOOKUP_BUMP: "lookup_bump",
}

# reentrant: a tape collected while this thread holds the lock releases its tables
ENGINE_LOCK = threading.RLock()
# seconds the g++ build took in this process (0.0: loaded as built before)
BUILD_SECONDS: float | None = None

_lib = None
_next_slot = [1]


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join((CXX, *CXX_FLAGS)).encode())
    return BUILD_DIR / f"resolver-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile resolver.cpp unless it is built; returns the library's path."""
    global BUILD_SECONDS
    out = library_path()
    if out.exists():
        if BUILD_SECONDS is None:
            BUILD_SECONDS = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        r = subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, str(SRC)],
                           capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(
            f"the native witness resolver needs the C++ compiler {CXX!r}, which "
            f"was not found") from e
    if r.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed to build native/resolver.cpp:\n{r.stderr}")
    os.replace(tmp, out)
    BUILD_SECONDS = time.perf_counter() - t0
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded engine with its Poseidon2 constants registered, built first
    if needed."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.register_table.argtypes = [i64, vp, i64, ctypes.c_int, ctypes.c_int]
    lib.register_table.restype = ctypes.c_int
    lib.release_table.argtypes = [i64]
    lib.release_table.restype = None
    lib.table_multiplicities.argtypes = [i64, ctypes.POINTER(i64)]
    lib.table_multiplicities.restype = ctypes.POINTER(ctypes.c_uint32)
    lib.register_poseidon2.argtypes = [vp, vp]
    lib.register_poseidon2.restype = None
    lib.execute_stream.argtypes = [vp, vp, vp, i64]
    lib.execute_stream.restype = i64
    from ..hashes import poseidon2_params as p2

    rc = np.array(p2.ALL_ROUND_CONSTANTS, dtype=np.uint64)
    diag = np.array(p2.M_I_DIAGONAL, dtype=np.uint64)
    assert rc.shape == (360,) and diag.shape == (12,)
    lib.register_poseidon2(rc.ctypes.data, diag.ctypes.data)
    _lib = lib
    return lib


class NativeTape:
    """Typed ops accumulated during synthesis, run in batches.

    `stream` holds the ops, `num_ops` counts them. Taking a snapshot starts
    a fresh stream, so a worker thread can run one batch while synthesis
    appends to the next. Local table ids map to process-global engine
    slots (`slot`)."""

    def __init__(self, lib):
        self.lib = lib
        self.slot: dict[int, int] = {}
        self.stream = array("Q")
        self.num_ops = 0

    # -- tables ---------------------------------------------------------------

    def ensure_table(self, table_id: int, table) -> int:
        slot = self.slot.get(table_id)
        if slot is not None:
            return slot
        content = np.ascontiguousarray(table.content, dtype=np.uint64)
        with ENGINE_LOCK:
            slot = _next_slot[0]
            _next_slot[0] += 1
            rc = self.lib.register_table(slot, content.ctypes.data, len(content),
                                         table.width, table.num_keys)
        if rc != 0:
            raise RuntimeError(f"native resolver refused table {table.name} (code {rc})")
        self.slot[table_id] = slot
        return slot

    def multiplicities_of(self, table_id: int):
        """The engine's counts for the rows of a local table, or None."""
        slot = self.slot.get(table_id)
        if slot is None:
            return None
        rows = ctypes.c_int64()
        with ENGINE_LOCK:
            ptr = self.lib.table_multiplicities(slot, ctypes.byref(rows))
            return np.ctypeslib.as_array(ptr, shape=(rows.value,)).copy()

    def release_tables(self):
        with ENGINE_LOCK:
            for slot in self.slot.values():
                self.lib.release_table(slot)
        self.slot.clear()

    def __del__(self):
        if self.slot and ENGINE_LOCK is not None:
            self.release_tables()

    # -- batches --------------------------------------------------------------

    def take_snapshot(self):
        """Detach the accumulated ops (the tape starts afresh), or None."""
        if not self.num_ops:
            return None
        snap = self.stream
        self.stream = array("Q")
        self.num_ops = 0
        return snap

    def run_snapshot(self, values_addr: int, state_addr: int, snap) -> None:
        """Run one batch against the arena: values at `values_addr`, state
        bytes at `state_addr`. The ctypes call releases the GIL. A failed
        batch is never run again: the ops before the failing one have run
        (a second pass would count their lookups twice)."""
        with ENGINE_LOCK:
            rc = self.lib.execute_stream(values_addr, state_addr, snap.buffer_info()[0],
                                         len(snap))
        if rc != 0:
            kind = snap[-int(rc) - 1]
            raise RuntimeError(
                f"native resolver op {OP_NAMES.get(kind, kind)} failed: lookup miss, "
                "oversized key, or unregistered table")
