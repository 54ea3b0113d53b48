"""The fma-chain circuit of bench.py (`build_fma` and its proof config) over
the port's front end, the circuit the port is measured and tested on.

16 copy columns, no witness columns, 6 constant columns, constraint degree
3: each row holds FmaGate repetitions chaining (a, b) -> (b, a·b + a), the
last value is a public input. Proved at LDE 4, cap 16, 50 queries, no PoW,
final FRI degree 16.
"""

from __future__ import annotations

from .cs.gates import FmaGate, PublicInputGate
from .cs.implementations import ConstraintSystem
from .cs.types import CSGeometry
from .prover.config import ProofConfig

FMA_GEOMETRY = CSGeometry(
    num_columns_under_copy_permutation=16,
    num_witness_columns=0,
    num_constant_columns=6,
    max_allowed_constraint_degree=3,
)


def build_fma(log_n: int) -> ConstraintSystem:
    """The fma chain filling 2^log_n rows (8 rows left for padding)."""
    cs = ConstraintSystem(FMA_GEOMETRY, 1 << log_n)
    a = cs.alloc_variable_with_value(1)
    b = cs.alloc_variable_with_value(2)
    per_row = FmaGate.instance().num_repetitions(FMA_GEOMETRY)
    for _ in range(((1 << log_n) - 8) * per_row):
        a, b = b, FmaGate.fma(cs, a, b, a, 1, 1)
    PublicInputGate.place(cs, b)
    return cs


def fma_proof_config() -> ProofConfig:
    return ProofConfig(fri_lde_factor=4, merkle_tree_cap_size=16, num_queries=50,
                       pow_bits=0, fri_final_degree=16)
