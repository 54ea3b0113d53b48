"""Circuit queues committed by hash chaining, as in the JAX package's
gadgets/queue.py (era-boojum gadgets/queue/: CircuitQueue mod.rs:29,
full_state_queue.rs): `push` folds the element into the tail commitment,
`pop_front` folds the (witness) element into the head commitment, and
`enforce_consistency` ties the ends together, so the popped sequence must
be the pushed one. The length is a range-checked counter, checked again
after each pop, so it cannot underflow.

`CircuitQueue` commits with 4 elements (a sponge's capacity);
`FullStateCircuitQueue` with the whole width-12 state, one permutation an
operation."""

from __future__ import annotations

from collections import deque

from ..cs.gates.simple import FmaGate
from ..field import gl
from .boolean import Boolean
from .chunk_utils import decompose_and_check
from .num import Num
from .poseidon2_rf import SW, circuit_hash_leaf, circuit_permutation
from .queue_optimizer import variable_length_hash_with_optimizer

T_COMMIT = 4


def _enforce_ends_meet(cs, queue):
    """Where the queue is empty, head equals tail (mod.rs:506)."""
    empty = queue.is_empty(cs)
    for h, t in zip(queue.head, queue.tail):
        diff = FmaGate.fma(cs, cs.one_var(), t, h, gl.P - 1, 1)
        FmaGate.enforce_fma(cs, empty.var, diff, cs.zero_var(), cs.zero_var(), 1, 0)


class CircuitQueue:
    """FIFO with 4-element head and tail commitments (mod.rs:29)."""

    def __init__(self, cs, element_width: int):
        zero = cs.zero_var()
        self.cs = cs
        self.element_width = element_width
        self.head = [zero] * T_COMMIT
        self.tail = [zero] * T_COMMIT
        self.length = Num(zero)
        self._witness: deque = deque()

    def push(self, cs, element_vars):
        assert len(element_vars) == self.element_width
        self.tail = circuit_hash_leaf(cs, list(element_vars) + self.tail)
        self.length = self.length.add_constant(cs, 1)
        decompose_and_check(cs, self.length.var, 32)  # UInt32::add_no_overflow
        self._witness.append([cs.get_value(v) for v in element_vars])

    def pop_front(self, cs):
        """The next element as witness, folded into the head; the length
        decremented and range-checked again (the underflow guard)."""
        el = [cs.alloc_variable_with_value(v) for v in self._witness.popleft()]
        self.head = circuit_hash_leaf(cs, el + self.head)
        self.length = self.length.add_constant(cs, gl.P - 1)
        decompose_and_check(cs, self.length.var, 32)
        return el

    def push_with_optimizer(self, cs, element_vars, execute: Boolean, id: int, optimizer):
        """A push under `execute` whose hash rounds are requests to a
        SpongeOptimizer (mod.rs:277)."""
        assert len(element_vars) == self.element_width
        new_tail = variable_length_hash_with_optimizer(
            cs, list(element_vars) + self.tail, id, execute, optimizer)
        self.tail = [Num.select(cs, execute, Num(a), Num(b)).var
                     for a, b in zip(new_tail, self.tail)]
        incremented = self.length.add_constant(cs, 1)
        decompose_and_check(cs, incremented.var, 32)
        self.length = Num.select(cs, execute, incremented, self.length)
        if execute.get_value(cs):
            self._witness.append([cs.get_value(v) for v in element_vars])

    def pop_with_optimizer(self, cs, execute: Boolean, id: int, optimizer):
        """A pop under `execute` through the optimizer (mod.rs:420)."""
        values = (self._witness.popleft() if execute.get_value(cs)
                  else [0] * self.element_width)
        el = [cs.alloc_variable_with_value(v) for v in values]
        new_head = variable_length_hash_with_optimizer(cs, el + self.head, id, execute,
                                                       optimizer)
        self.head = [Num.select(cs, execute, Num(a), Num(b)).var
                     for a, b in zip(new_head, self.head)]
        decremented = self.length.add_constant(cs, gl.P - 1)
        self.length = Num.select(cs, execute, decremented, self.length)
        decompose_and_check(cs, self.length.var, 32)
        return el

    def is_empty(self, cs) -> Boolean:
        return self.length.is_zero(cs)

    def enforce_consistency(self, cs):
        """Where the queue is drained, head equals tail: the popped sequence
        is the pushed one (mod.rs:506)."""
        _enforce_ends_meet(cs, self)

    def enforce_trivial_head(self, cs):
        zero = cs.zero_var()
        for h in self.head:
            FmaGate.enforce_fma(cs, cs.one_var(), h, zero, zero, 1, 0)


class FullStateCircuitQueue:
    """FIFO committed with the whole width-12 state (full_state_queue.rs):
    one permutation an operation, the element overwriting the rate."""

    def __init__(self, cs, element_width: int):
        assert element_width <= 8, "the element must fit the sponge's rate"
        zero = cs.zero_var()
        self.cs = cs
        self.element_width = element_width
        self.head = [zero] * SW
        self.tail = [zero] * SW
        self.length = Num(zero)
        self._witness: deque = deque()

    def _chain(self, cs, state, element_vars):
        rate = list(element_vars) + [cs.zero_var()] * (8 - self.element_width)
        return circuit_permutation(cs, rate + state[8:])

    def push(self, cs, element_vars):
        assert len(element_vars) == self.element_width
        self.tail = self._chain(cs, self.tail, element_vars)
        self.length = self.length.add_constant(cs, 1)
        self._witness.append([cs.get_value(v) for v in element_vars])

    def pop_front(self, cs):
        el = [cs.alloc_variable_with_value(v) for v in self._witness.popleft()]
        self.head = self._chain(cs, self.head, el)
        self.length = self.length.add_constant(cs, gl.P - 1)
        decompose_and_check(cs, self.length.var, 32)
        return el

    def is_empty(self, cs) -> Boolean:
        return self.length.is_zero(cs)

    def enforce_consistency(self, cs):
        _enforce_ends_meet(cs, self)
