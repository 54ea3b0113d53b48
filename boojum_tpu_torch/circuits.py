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
- general-purpose-column lookups (`build_general_lookup`), the circuit of
  the JAX package's tests/test_lookup_general.py (era-boojum
  lookup_placement.rs:21): 8 copy columns, no witness columns, 6 constant
  columns, degree 4, width-3 lookups on marker rows (8 // 3 = 2
  sub-arguments); each step a xor4 lookup, a 4-bit range check of its
  output and one FMA.
- witness columns (`build_zero_check_witness`), the circuit of the JAX
  package's tests/test_witness_columns.py (era-boojum zero_check.rs:591):
  8 copy columns, 4 witness columns, 6 constant columns, degree 4; each
  step an is_zero check with its inverse in a witness column and two FMAs.
Both grow step by step to fill 2^log_n rows; at log_n None they are the
JAX tests' own sizes, proved there with `small_proof_config()`, and the
card proves them at 2^20 with `sha256_proof_config()`.

The fma chain and the xor4 lookup circuit also synthesize over BabyBear
(`field="babybear"`), as the JAX package's tests/test_bb_full_prover.py
proves them; sha256 cannot (its u32 words need a field above 2^32).
"""

from __future__ import annotations

import numpy as np

from .cs.gates import FmaGate, PublicInputGate, ZeroCheckWitnessGate
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


def build_fma(log_n: int, field: str = "goldilocks") -> ConstraintSystem:
    """The fma chain filling 2^log_n rows (8 rows left for padding)."""
    cs = ConstraintSystem(FMA_GEOMETRY, 1 << log_n, field=field)
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


def build_xor_lookup(num_lookups: int = 30, capacity: int = 1 << 10, seed: int = 7,
                     field: str = "goldilocks"):
    """xor4 lookups of random nibbles (numpy seed `seed`), each output
    range-checked and folded into an FMA accumulator, which is the public
    input. Returns (cs, accumulator, last lookup output)."""
    cs = ConstraintSystem(XOR_GEOMETRY, capacity, lookup_params=XOR_LOOKUP, field=field)
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


def sha256_capacity(num_bytes: int) -> int:
    """bench.py's constraint-system capacity for sha256 over num_bytes."""
    return 1 << max(17, (num_bytes // 8192).bit_length() + 16)


def build_sha256(num_bytes: int = 8192, message: bytes | None = None):
    """sha256 of `message` (default: bench.py's message of num_bytes) over
    range-checked input bytes. Returns (cs, the 32 digest byte variables)."""
    if message is None:
        message = bench_message(num_bytes)
    cs = ConstraintSystem(SHA256_GEOMETRY, sha256_capacity(len(message)),
                          lookup_params=SHA256_LOOKUP)
    digest = sha256(cs, allocate_u8_input(cs, message))
    return cs, digest


def sha256_proof_config() -> ProofConfig:
    return ProofConfig(fri_lde_factor=8, merkle_tree_cap_size=16, num_queries=50,
                       pow_bits=0, fri_final_degree=16)


GENERAL_LOOKUP_GEOMETRY = CSGeometry(
    num_columns_under_copy_permutation=8,
    num_witness_columns=0,
    num_constant_columns=6,
    max_allowed_constraint_degree=4,
)
GENERAL_LOOKUP = LookupParameters(width=3, use_specialized_columns=False)

WITNESS_GEOMETRY = CSGeometry(
    num_columns_under_copy_permutation=8,
    num_witness_columns=4,
    num_constant_columns=6,
    max_allowed_constraint_degree=4,
)


def build_general_lookup(log_n: int | None = None, seed: int = 11):
    """Steps of a xor4 lookup of two random nibbles (numpy seed `seed`), a
    range check of its output and an FMA folding it into an accumulator,
    the public input. A step takes 1.5 rows (each row holds two lookup
    tuples or two FMAs), so 2·((2^log_n - 8) // 3) steps fill 2^log_n rows;
    log_n None: the JAX test's 20 steps, 2^9 rows (the tables' size).
    Returns (cs, accumulator)."""
    steps = 20 if log_n is None else 2 * (((1 << log_n) - 8) // 3)
    cs = ConstraintSystem(GENERAL_LOOKUP_GEOMETRY, 1 << (log_n or 10),
                          lookup_params=GENERAL_LOOKUP)
    xor_id = cs.add_lookup_table(xor4_table())
    rc_id = cs.add_lookup_table(range_check_table(4))
    rng = np.random.default_rng(seed)
    acc = cs.alloc_variable_with_value(1)
    for _ in range(steps):
        a = cs.alloc_variable_with_value(int(rng.integers(16)))
        b = cs.alloc_variable_with_value(int(rng.integers(16)))
        (out,) = cs.perform_lookup(xor_id, [a, b])
        cs.enforce_lookup(rc_id, [out, cs.zero_var()])
        acc = FmaGate.fma(cs, acc, out, a, 1, 1)
    PublicInputGate.place(cs, acc)
    return cs, acc


def build_zero_check_witness(log_n: int | None = None):
    """Steps of is_zero(i mod 3), the flag squared-and-added into an
    accumulator and summed into flags_sum, the public input. A step takes
    1.25 rows (four is_zero instances or two FMAs a row), so
    4·((2^log_n - 8) // 5) steps fill 2^log_n rows; log_n None: the JAX
    test's 12 steps. Returns (cs, flags_sum)."""
    steps = 12 if log_n is None else 4 * (((1 << log_n) - 8) // 5)
    cs = ConstraintSystem(WITNESS_GEOMETRY, 1 << (log_n or 10))
    acc = cs.alloc_variable_with_value(3)
    flags_sum = cs.zero_var()
    for i in range(steps):
        x = cs.alloc_variable_with_value(i % 3)
        flag = ZeroCheckWitnessGate.is_zero(cs, x)
        acc = FmaGate.fma(cs, acc, acc, flag, 1, 1)
        flags_sum = FmaGate.fma(cs, flags_sum, cs.one_var(), flag, 1, 1)
    PublicInputGate.place(cs, flags_sum)
    return cs, flags_sum


def small_proof_config() -> ProofConfig:
    """The proof config of the JAX package's witness-column and
    general-lookup tests."""
    return ProofConfig(fri_lde_factor=8, merkle_tree_cap_size=4, num_queries=8,
                       pow_bits=0, fri_final_degree=4)
