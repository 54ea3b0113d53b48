"""The flattened legacy Poseidon gate of the JAX package's
cs/gates/poseidon_flat.py (era-boojum poseidon.rs:1249
`PoseidonFlattenedGate`): the whole legacy Poseidon permutation across one
row, with the degree resets of the Poseidon2 gate (poseidon2_flat.py).

Legacy schedule (hashes/poseidon.py): no initial MDS; 4 full rounds (round
constants, x^7 on every lane, the circulant MDS), 22 partial rounds (round
constants on every lane, x^7 on lane 0, MDS), 4 full rounds. Resets: all 12
lanes before full rounds 1 to 3 (36), lane 0's S-box input in every partial
round (22), all 12 lanes before each last full round (48): 106 aux, so the
gate spans 12 + 12 + 106 = 130 copy columns, as the Poseidon2 gate does.
Goldilocks only.
"""

from __future__ import annotations

from ...hashes.poseidon import MDS_MATRIX_EXPS, RC
from .poseidon2_flat import (
    HALF_FULL, NUM_AUX, NUM_PARTIAL, SW, WIDTH, FlattenedPermutationGate, pow7, trace_of,
)

__all__ = ["NUM_AUX", "SW", "WIDTH", "PoseidonFlattenedGate", "legacy_flat_permutation"]


def _circulant_mds(ops, s):
    """M·s with the circulant of powers of two (suggested_mds.rs:11):
    products by constants keep the degree."""
    out = []
    for r in range(SW):
        acc = None
        for c in range(SW):
            term = ops.mul(s[c], ops.constant(1 << MDS_MATRIX_EXPS[(c - r) % SW]))
            acc = term if acc is None else ops.add(acc, term)
        out.append(acc)
    return out


def legacy_flat_permutation(ops, state, reset):
    """The legacy Poseidon permutation with a `reset(value) -> value` hook at
    every degree-reset point (the module's schedule)."""
    for r in range(HALF_FULL):
        if r != 0:
            state = [reset(v) for v in state]
        state = [pow7(ops, ops.add(v, ops.constant(RC[r][i]))) for i, v in enumerate(state)]
        state = _circulant_mds(ops, state)
    for p in range(NUM_PARTIAL):
        rc = RC[HALF_FULL + p]
        state = [ops.add(v, ops.constant(rc[i])) for i, v in enumerate(state)]
        state[0] = pow7(ops, reset(state[0]))
        state = _circulant_mds(ops, state)
    for r in range(HALF_FULL):
        state = [reset(v) for v in state]
        rc = RC[HALF_FULL + NUM_PARTIAL + r]
        state = [pow7(ops, ops.add(v, ops.constant(rc[i]))) for i, v in enumerate(state)]
        state = _circulant_mds(ops, state)
    return state


def _witness_trace(input_values):
    """(outputs, aux values) of one legacy permutation over host ints."""
    return trace_of(legacy_flat_permutation, input_values)


class PoseidonFlattenedGate(FlattenedPermutationGate):
    name = "poseidon_flat"
    feature = "the flattened Poseidon gate (Goldilocks round constants)"
    permutation_fn = staticmethod(legacy_flat_permutation)
