"""Symbolic gate-program capture.

A gate's evaluator runs once over symbolic values; every field op it makes
is recorded as a straight-line SSA program (loads of copy/witness/constant
cells, inlined constants, add/sub/mul/neg/double ops, term slots). The
quotient-sweep kernel replays these programs from a table
(prover/quotient_sweep.py), so a gate needs no CUDA code of its own. Same
contract as the JAX package's cs/gate_capture.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..field import gl
from .gates.base import RowView, TermsCollector

OPCODES = {"add": 0, "sub": 1, "mul": 2, "neg": 3, "double": 4}
LOAD_KINDS = {"v": 0, "w": 1, "c": 2}


@dataclass(frozen=True)
class Sym:
    """A symbolic value: an SSA slot index."""

    idx: int


@dataclass
class GateProgram:
    gate_name: str = ""
    loads: list = field(default_factory=list)  # (slot, kind, index)
    consts: list = field(default_factory=list)  # (slot, value)
    ops: list = field(default_factory=list)  # (op, dst, a_slot, b_slot)
    terms: list = field(default_factory=list)  # slot per quotient term
    num_slots: int = 0

    def evaluate(self, ops_ctx, row: RowView):
        """Interpret over any field-like ops context; returns the terms."""
        slots = [None] * self.num_slots
        for slot, kind, index in self.loads:
            slots[slot] = {"v": row.v, "w": row.w, "c": row.c}[kind](index)
        for slot, value in self.consts:
            slots[slot] = ops_ctx.constant(value)
        for op, dst, a, b in self.ops:
            if op in ("neg", "double"):
                slots[dst] = getattr(ops_ctx, op)(slots[a])
            else:
                slots[dst] = getattr(ops_ctx, op)(slots[a], slots[b])
        return [slots[t] for t in self.terms]


class _CaptureOps:
    def __init__(self, program: GateProgram):
        self.p = program

    def _new(self) -> int:
        s = self.p.num_slots
        self.p.num_slots += 1
        return s

    def zero(self):
        return self.constant(0)

    def one(self):
        return self.constant(1)

    def constant(self, v: int):
        s = self._new()
        self.p.consts.append((s, int(v) % gl.P))
        return Sym(s)

    def _op(self, op, a: Sym, b: Sym):
        s = self._new()
        self.p.ops.append((op, s, a.idx, b.idx))
        return Sym(s)

    def add(self, a, b):
        return self._op("add", a, b)

    def sub(self, a, b):
        return self._op("sub", a, b)

    def mul(self, a, b):
        return self._op("mul", a, b)

    def neg(self, a):
        return self._op("neg", a, a)

    def double(self, a):
        return self._op("double", a, a)


def capture_gate_program(gate) -> GateProgram:
    """Run the gate's evaluator once over symbolic values."""
    p = GateProgram(gate_name=gate.name)
    ops = _CaptureOps(p)
    cache: dict = {}

    def loader(kind):
        def get(i):
            key = (kind, i)
            if key not in cache:
                s = ops._new()
                p.loads.append((s, kind, i))
                cache[key] = Sym(s)
            return cache[key]

        return get

    dst = TermsCollector()
    gate.evaluate(ops, RowView(loader("v"), loader("w"), loader("c")), dst)
    p.terms = [t.idx for t in dst.terms]
    return p
