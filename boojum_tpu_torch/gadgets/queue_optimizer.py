"""Sponge rounds shared across mutually exclusive queue operations, as in
the JAX package's gadgets/queue_optimizer.py (era-boojum
gadgets/queue/queue_optimizer/sponge_optimizer.rs, mod.rs): where a circuit
runs at most one of N queue operations a step, each registers a request
(initial state, claimed final state, applies) under its stream id, and
`enforce()` lays down one permutation a request slot, selecting among the
slot's requests by their at-most-one-hot flags and enforcing the selected
claimed state where it applies. The claimed states are witnesses (zeros
where the operation does not run)."""

from __future__ import annotations

from ..cs.gates.simple import FmaGate, ReductionGate
from ..field import gl
from ..hashes.poseidon2 import poseidon2_permutation_host
from .boolean import Boolean
from .num import Num
from .poseidon2_rf import RATE, SW, circuit_permutation

T_COMMIT = 4


class SpongeOptimizer:
    """Sponge-round requests of `num_ids` mutually exclusive streams, laid
    down as at most `capacity` permutations (sponge_optimizer.rs)."""

    def __init__(self, cs, capacity: int, num_ids: int):
        self.cs = cs
        self.capacity = capacity
        self.num_ids = num_ids
        self.requests: list[list] = [[] for _ in range(num_ids)]

    def add_request(self, initial_state, claimed_final_state, applies: Boolean, id: int):
        assert len(initial_state) == SW and len(claimed_final_state) == SW
        stream = self.requests[id]
        assert len(stream) < self.capacity, (
            f"over capacity: capacity is {self.capacity} but stream {id} "
            f"already has {len(stream)} requests")
        stream.append((list(initial_state), list(claimed_final_state), applies))

    def is_fresh(self) -> bool:
        return all(not s for s in self.requests)

    def enforce(self):
        """One permutation a request slot: the slot's requests selected by
        their flags, whose sum is checked boolean (at most one set) and is
        the combined flag, and the selected claimed state enforced under
        it."""
        cs = self.cs
        zero = cs.zero_var()
        for slot in range(self.capacity):
            per_slot = [s[slot] for s in self.requests if slot < len(s)]
            if not per_slot:
                continue
            if len(per_slot) == 1:
                init, claimed, applies = per_slot[0]
            else:
                bit_sum = per_slot[0][2].var
                for f in per_slot[1:]:
                    bit_sum = ReductionGate.reduce(cs, [bit_sum, f[2].var, zero, zero],
                                                   [1, 1, 0, 0])
                applies = Boolean.from_variable_checked(cs, bit_sum)
                init, claimed, _ = per_slot[0]
                for nxt_init, nxt_claimed, flag in per_slot[1:]:
                    init = [Num.select(cs, flag, Num(a), Num(b)).var
                            for a, b in zip(nxt_init, init)]
                    claimed = [Num.select(cs, flag, Num(a), Num(b)).var
                               for a, b in zip(nxt_claimed, claimed)]
            result = circuit_permutation(cs, init)
            for res, want in zip(result, claimed):
                diff = FmaGate.fma(cs, cs.one_var(), want, res, gl.P - 1, 1)
                FmaGate.enforce_fma(cs, applies.var, diff, zero, zero, 1, 0)
        for s in self.requests:
            s.clear()


def absorb_into_state_with_optimizer(cs, input_vars, into_state, id: int, execute: Boolean,
                                     optimizer):
    """Overwrite-mode absorption of `input_vars` into `into_state` whose
    permutations are optimizer requests (mod.rs
    `variable_length_absorb_into_state_using_optimizer`): each round's
    state is a witness, zeros where `execute` is false."""
    zero = cs.zero_var()
    chunks = []
    rem = list(input_vars)
    while rem:
        head, rem = rem[:RATE], rem[RATE:]
        chunks.append(head + [zero] * (RATE - len(head)))
    state = list(into_state)
    for chunk in chunks:
        outs = cs.alloc_multiple_variables_without_values(SW)

        def resolve(vals):
            st, absorbed, exe = vals[:SW], vals[SW:SW + RATE], vals[SW + RATE]
            if exe == 0:
                return [0] * SW
            return poseidon2_permutation_host(list(absorbed) + list(st[RATE:]))

        cs.set_values_with_dependencies(state + chunk + [execute.var], outs, resolve)
        optimizer.add_request(chunk + state[RATE:], outs, execute, id)
        state = list(outs)
    return state


def variable_length_hash_with_optimizer(cs, input_vars, id: int, execute: Boolean, optimizer,
                                        n=T_COMMIT):
    """The `n`-element hash of `input_vars` from an empty state, through the
    optimizer (mod.rs `variable_length_hash_using_optimizer`)."""
    zero = cs.zero_var()
    state = absorb_into_state_with_optimizer(cs, input_vars, [zero] * SW, id, execute,
                                             optimizer)
    return state[:n]
