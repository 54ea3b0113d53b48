"""The circuits the port is measured and tested on, over its front end.

- bench.py's fma chain (`build_fma`): 16 copy columns, no witness columns,
  6 constant columns, constraint degree 3; each row holds FmaGate
  repetitions chaining (a, b) -> (b, a·b + a), the last value is a public
  input. Proved at LDE 4, cap 16, 50 queries, no PoW, final FRI degree 16.
- the xor4 lookup circuit of the JAX package's examples.py
  (`build_xor_lookup`): xor4 lookups and 4-bit range checks chained
  through an FMA accumulator, 8 copy columns, width-3 ×2 lookups.
- bench.py's headline, sha256 (`build_sha256`): 60 copy columns, 8
  constant columns, degree 7, width-4 ×8 specialized lookups; 8 KiB pad to
  2^16 rows. Proved at LDE 8, cap 16, 50 queries, no PoW, final degree 16.
"""

from __future__ import annotations

import numpy as np

from .cs.gates import FmaGate, PublicInputGate
from .cs.implementations import ConstraintSystem
from .cs.lookup_table import LookupTable, range_check_table
from .cs.types import CSGeometry, LookupParameters
from .gadgets import allocate_u8_input, sha256
from .prover.config import ProofConfig

FMA_GEOMETRY = CSGeometry(
    num_columns_under_copy_permutation=16,
    num_witness_columns=0,
    num_constant_columns=6,
    max_allowed_constraint_degree=3,
)

XOR_GEOMETRY = CSGeometry(
    num_columns_under_copy_permutation=8,
    num_witness_columns=0,
    num_constant_columns=6,
    max_allowed_constraint_degree=4,
)
XOR_LOOKUP = LookupParameters(width=3, num_repetitions=2)

SHA256_GEOMETRY = CSGeometry(
    num_columns_under_copy_permutation=60,
    num_witness_columns=0,
    num_constant_columns=8,
    max_allowed_constraint_degree=7,
)
SHA256_LOOKUP = LookupParameters(width=4, num_repetitions=8)


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


def xor4_table() -> LookupTable:
    a = np.arange(16, dtype=np.uint64).repeat(16)
    b = np.tile(np.arange(16, dtype=np.uint64), 16)
    return LookupTable("xor4", 2, 1, np.stack([a, b, a ^ b], axis=1))


def build_xor_lookup(num_lookups: int = 30, capacity: int = 1 << 10, seed: int = 7):
    """xor4 lookups of random nibbles (numpy seed `seed`), each output
    range-checked and folded into an FMA accumulator, which is the public
    input. Returns (cs, accumulator, last lookup output)."""
    cs = ConstraintSystem(XOR_GEOMETRY, capacity, lookup_params=XOR_LOOKUP)
    xor_id = cs.add_lookup_table(xor4_table())
    rc_id = cs.add_lookup_table(range_check_table(4))
    rng = np.random.default_rng(seed)
    acc = cs.alloc_variable_with_value(1)
    last_out = None
    for _ in range(num_lookups):
        a = cs.alloc_variable_with_value(int(rng.integers(16)))
        b = cs.alloc_variable_with_value(int(rng.integers(16)))
        (out,) = cs.perform_lookup(xor_id, [a, b])
        cs.enforce_lookup(rc_id, [out, cs.zero_var()])
        acc = FmaGate.fma(cs, acc, out, a, 1, 1)
        last_out = out
    PublicInputGate.place(cs, acc)
    return cs, acc, last_out


def xor_lookup_proof_config() -> ProofConfig:
    return ProofConfig(fri_lde_factor=8, merkle_tree_cap_size=4, num_queries=20,
                       pow_bits=0, fri_final_degree=4)


def bench_message(num_bytes: int) -> bytes:
    """bench.py's sha256 message: bytes i mod 255."""
    return bytes(i % 255 for i in range(num_bytes))


def build_sha256(num_bytes: int = 8192, message: bytes | None = None):
    """sha256 of `message` (default: bench.py's message of num_bytes) over
    range-checked input bytes. Returns (cs, the 32 digest byte variables)."""
    if message is None:
        message = bench_message(num_bytes)
    capacity = 1 << max(17, (len(message) // 8192).bit_length() + 16)
    cs = ConstraintSystem(SHA256_GEOMETRY, capacity, lookup_params=SHA256_LOOKUP)
    digest = sha256(cs, allocate_u8_input(cs, message))
    return cs, digest


def sha256_proof_config() -> ProofConfig:
    return ProofConfig(fri_lde_factor=8, merkle_tree_cap_size=16, num_queries=50,
                       pow_bits=0, fri_final_degree=16)
