"""The flattened Poseidon2 gate of the JAX package's
cs/gates/poseidon2_flat.py (era-boojum poseidon2.rs
`Poseidon2RoundFunctionFlattenedEvaluator`): one width-12 permutation a
row, 12 inputs, 12 outputs and an auxiliary variable wherever the running
state would pass degree 7 (each full round's S-box inputs after the first,
each partial round's lane-0 S-box input), each tying `state - aux = 0`; the
last external MDS is tied to the outputs. 12 + 12 + 106 = 130 copy
columns, the Era recursion geometry's.

One traversal (`flat_permutation`) drives the constraint evaluator (over
field-like ops) and the witness (over host ints). Goldilocks only: over
BabyBear the gate is refused at synthesis. A permutation's witness goes to
the native tape as one OP_POSEIDON2 op (12 outputs, then the 106
auxiliaries in this traversal's order), with `_witness_trace` as its
portable closure.
"""

from __future__ import annotations

from ...field import gl
from ...hashes import poseidon2_params as params
from ...native import OP_POSEIDON2
from ..field_like import ScalarOps
from .base import Gate

SW = 12
HALF_FULL = 4
NUM_PARTIAL = 22
# every 64-bit word a Goldilocks element: the round constants are
FIELD_BITS = 63

_RC = [[int(c) for c in params.ALL_ROUND_CONSTANTS[12 * r : 12 * r + 12]] for r in range(30)]
_DIAG = [int(d) for d in params.M_I_DIAGONAL]

NUM_AUX = (HALF_FULL - 1) * SW + NUM_PARTIAL + HALF_FULL * SW  # 106
WIDTH = 2 * SW + NUM_AUX  # 130


def _ext_mds(ops, s):
    """circ(2·M4, M4, M4) by the add and double chain of
    hashes/poseidon2.py `_external_mds`."""

    def block(x0, x1, x2, x3):
        t0 = ops.add(x0, x1)
        t1 = ops.add(x2, x3)
        t2 = ops.add(ops.double(x1), t1)
        t3 = ops.add(ops.double(x3), t0)
        t4 = ops.add(ops.double(ops.double(t1)), t3)
        t5 = ops.add(ops.double(ops.double(t0)), t2)
        return ops.add(t3, t5), t5, ops.add(t2, t4), t4

    blocks = [block(*s[4 * b : 4 * b + 4]) for b in range(3)]
    sums = [ops.add(ops.add(blocks[0][i], blocks[1][i]), blocks[2][i]) for i in range(4)]
    return [ops.add(blocks[b][i], sums[i]) for b in range(3) for i in range(4)]


def _int_mds(ops, s):
    total = s[0]
    for v in s[1:]:
        total = ops.add(total, v)
    return [ops.add(ops.mul(v, ops.constant(_DIAG[i])), total) for i, v in enumerate(s)]


def pow7(ops, x):
    x2 = ops.mul(x, x)
    x3 = ops.mul(x2, x)
    return ops.mul(ops.mul(x2, x2), x3)


def flat_permutation(ops, state, reset):
    """The Poseidon2 permutation with a `reset(value) -> value` hook at every
    degree-reset point: the evaluator's takes the next aux variable and
    emits `value - aux`, the witness's records the value."""
    state = _ext_mds(ops, state)
    for r in range(HALF_FULL):
        if r != 0:
            state = [reset(v) for v in state]
        state = [pow7(ops, ops.add(v, ops.constant(_RC[r][i]))) for i, v in enumerate(state)]
        state = _ext_mds(ops, state)
    for p in range(NUM_PARTIAL):
        s0 = ops.add(state[0], ops.constant(_RC[HALF_FULL + p][0]))
        state[0] = pow7(ops, reset(s0))
        state = _int_mds(ops, state)
    for r in range(HALF_FULL):
        state = [reset(v) for v in state]
        rc = _RC[HALF_FULL + NUM_PARTIAL + r]
        state = [pow7(ops, ops.add(v, ops.constant(rc[i]))) for i, v in enumerate(state)]
        state = _ext_mds(ops, state)
    return state


def trace_of(permutation, input_values):
    """(outputs, aux values) of one flattened permutation over host ints."""
    aux = []

    def reset(v):
        aux.append(v)
        return v

    out = permutation(ScalarOps, [v % gl.P for v in input_values], reset)
    return out, aux


def _witness_trace(input_values):
    """(outputs, aux values) of one Poseidon2 permutation over host ints."""
    return trace_of(flat_permutation, input_values)


class FlattenedPermutationGate(Gate):
    """A width-12 permutation inscribed across one 130-column row; a
    subclass names the traversal (`permutation_fn`)."""

    principal_width = WIDTH
    num_terms = NUM_AUX + SW
    max_degree = 7
    feature = "?"
    native = None  # the typed-op descriptor of a permutation, if the tape has one

    @staticmethod
    def permutation_fn(ops, state, reset):
        raise NotImplementedError

    def evaluate(self, ops, row, dst):
        state = [row.v(i) for i in range(SW)]
        output = [row.v(SW + i) for i in range(SW)]
        cursor = [2 * SW]

        def reset(v):
            aux = row.v(cursor[0])
            cursor[0] += 1
            dst.push(ops.sub(v, aux))
            return aux

        state = self.permutation_fn(ops, state, reset)
        assert cursor[0] == WIDTH
        for s, o in zip(state, output):
            dst.push(ops.sub(o, s))

    def padding_instance(self, cs, constants=()):
        zero = cs.zero_var()
        outs, aux = trace_of(self.permutation_fn, [0] * SW)
        vals = outs + aux
        places = cs.alloc_multiple_variables_without_values(len(vals))
        cs.set_values_with_dependencies([], places, lambda _: vals)
        return [zero] * SW + places

    @classmethod
    def permutation(cls, cs, input_vars):
        """Allocate and constrain the outputs of one permutation of the 12
        input variables; returns the 12 output variables."""
        assert len(input_vars) == SW
        cs.require_field_bits(FIELD_BITS, cls.feature)
        outs = cs.alloc_multiple_variables_without_values(SW)
        auxs = cs.alloc_multiple_variables_without_values(NUM_AUX)

        def resolve(vals):
            out, aux = trace_of(cls.permutation_fn, vals)
            return out + aux

        cs.set_values_with_dependencies(list(input_vars), outs + auxs, resolve, cls.native)
        cs.place_gate(cls.instance(), list(input_vars) + outs + auxs, ())
        return outs


class Poseidon2FlattenedGate(FlattenedPermutationGate):
    name = "poseidon2_flat"
    feature = "the flattened Poseidon2 gate (Goldilocks round constants)"
    permutation_fn = staticmethod(flat_permutation)
    native = (OP_POSEIDON2, ())
