"""A proof and a verification key as circuit witnesses, as in the JAX
package's gadgets/recursion/allocated_proof.py (era-boojum
allocated_proof.rs, allocated_vk.rs): every field element of a proof and
the VK's setup cap become allocated variables; the fixed parameters
(geometry, FRI schedule, gates) stay on the host, where they shape the
circuit."""

from __future__ import annotations

from ...field import gl


def _alloc(cs, v: int) -> int:
    return cs.alloc_variable_with_value(int(v) % gl.P)


def _alloc_cap(cs, cap):
    return [[_alloc(cs, x) for x in digest] for digest in cap]


def _alloc_pairs(cs, pairs):
    return [(_alloc(cs, c0), _alloc(cs, c1)) for (c0, c1) in pairs]


class AllocatedOracleQuery:
    def __init__(self, cs, query):
        self.leaf_values = [_alloc(cs, v) for v in query.leaf_values]
        self.path = [[_alloc(cs, x) for x in sib] for sib in query.path]


class AllocatedSingleRoundQueries:
    def __init__(self, cs, q):
        self.witness = AllocatedOracleQuery(cs, q.witness)
        self.stage2 = AllocatedOracleQuery(cs, q.stage2)
        self.quotient = AllocatedOracleQuery(cs, q.quotient)
        self.setup = AllocatedOracleQuery(cs, q.setup)
        self.fri = [AllocatedOracleQuery(cs, f) for f in q.fri]


class AllocatedProof:
    """Every field element of a proof, allocated in its order
    (allocated_proof.rs)."""

    def __init__(self, cs, proof):
        self.public_inputs = [_alloc(cs, v) for v in proof.public_inputs]
        self.witness_cap = _alloc_cap(cs, proof.witness_cap)
        self.stage2_cap = _alloc_cap(cs, proof.stage2_cap)
        self.quotient_cap = _alloc_cap(cs, proof.quotient_cap)
        self.values_at_z = _alloc_pairs(cs, proof.values_at_z)
        self.values_at_z_omega = _alloc_pairs(cs, proof.values_at_z_omega)
        self.values_at_0 = _alloc_pairs(cs, proof.values_at_0)
        self.fri_caps = [_alloc_cap(cs, c) for c in proof.fri_caps]
        self.final_fri_monomials = _alloc_pairs(cs, proof.final_fri_monomials)
        self.queries = [AllocatedSingleRoundQueries(cs, q) for q in proof.queries]
        self.pow_challenge = _alloc(cs, proof.pow_challenge)


class AllocatedVerificationKey:
    """The VK's setup cap as witnesses; the rest stays on `vk`
    (allocated_vk.rs)."""

    def __init__(self, cs, vk):
        self.setup_merkle_cap = _alloc_cap(cs, vk.setup_merkle_cap)
        self.vk = vk
