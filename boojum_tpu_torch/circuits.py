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
- keccak256 and blake2s (`build_keccak256`, `build_blake2s`), the circuits
  of the JAX package's tests/test_keccak.py and tests/test_blake2s.py, at
  the sha256 geometry and lookups: bytes as 8-bit xor/and table lookups,
  rotations through byte-split tables, blake2s's additions on the byte
  tri-add gate. Their tables set the least trace: 2^18 rows for keccak256
  (xor8 and and8, 2^16 rows each), 2^17 for blake2s (xor8); log_n grows
  the message to fill 2^log_n rows.
- the gate zoo (`build_gate_zoo`): every gate of the JAX package's
  cs/gates/simple.py and cs/gates/u32.py, most through the Boolean, Num
  and UInt gadgets, in a circuit without lookups (ranges by booleans), so
  it fits 2^8 rows for CPU proofs.

- the secp256k1 double-and-add ladder (`build_secp256k1_ladder`), the
  inner loop of era's ecrecover precompile: non-native secp256k1 field
  arithmetic over 16-bit limbs at the sha256 geometry and lookups (limb
  ranges through the 4-bit TriXor4 table); one ladder step a bit of a
  scalar drawn from a seed, the result in affine coordinates. The JAX
  package's tests/test_nnf_curves.py circuits at depth.

- the toy Poseidon-style round function of the JAX package's examples.py
  (`build_poseidon_rf`): a width-3 state, a round an x^7 + c S-box per lane
  and a circulant MDS, degree 7 at the fma geometry of xor4.
- the recursion layer (`build_recursion`): Era's verifier circuit, 130
  copy columns, 8 constant columns, degree 7 (`recursion_geometry`), whose
  witness is one or more Boojum proofs of one VK, each verified inside the
  circuit (gadgets/recursion/), the inner public inputs placed as its own.
  The JAX tests' inner circuit is a Fibonacci chain (`fibonacci`) proved at
  16 rows with `recursion_inner_config()`; the card's, sha256 over 8 KiB.

The fma chain, the xor4 lookup circuit and the toy round function also
synthesize over BabyBear (`field="babybear"`), as the JAX package's
tests/test_bb_full_prover.py proves them; sha256 cannot (its u32 words need
a field above 2^32).
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np

from .cs import gates
from .cs.gates import (
    BooleanConstraintGate, FmaGate, MatrixMultiplicationGate, PublicInputGate, SelectionGate,
    SimpleNonlinearityGate, ZeroCheckWitnessGate,
)
from .cs.implementations import ConstraintSystem
from .cs.lookup_table import LookupTable, range_check_table
from .cs.types import DEV_CS_CONFIG, CSGeometry, LookupParameters
from .field import gl
from .gadgets import (
    SECP256K1_BASE, Boolean, NonNativeField, Num, SWProjectivePoint, UInt8, UInt16, UInt32,
    allocate_u8_input, blake2s, keccak256, sha256,
)
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


def build_fma(log_n: int, field: str = "goldilocks", config=DEV_CS_CONFIG) -> ConstraintSystem:
    """The fma chain filling 2^log_n rows (8 rows left for padding);
    `config` goes to the ConstraintSystem."""
    cs = ConstraintSystem(FMA_GEOMETRY, 1 << log_n, config, field=field)
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


def build_sha256(num_bytes: int = 8192, message: bytes | None = None,
                 config=DEV_CS_CONFIG):
    """sha256 of `message` (default: bench.py's message of num_bytes) over
    range-checked input bytes; `config` goes to the ConstraintSystem.
    Returns (cs, the 32 digest byte variables)."""
    if message is None:
        message = bench_message(num_bytes)
    cs = ConstraintSystem(SHA256_GEOMETRY, sha256_capacity(len(message)), config,
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


KECCAK_ROWS_PER_BLOCK = 3101  # lookup rows a 136-byte block takes, at least
BLAKE2S_ROWS_PER_BLOCK = 294  # lookup rows a 64-byte block takes, at least


def keccak256_message_len(log_n: int) -> int:
    """Bytes of bench_message whose keccak256 fills 2^log_n rows: whole
    blocks of 136 bytes (the last takes its one padding byte), each 3101
    lookup rows or fewer, 16 rows to spare."""
    return 136 * (((1 << log_n) - 16) // KECCAK_ROWS_PER_BLOCK) - 1


def blake2s_message_len(log_n: int) -> int:
    """Bytes of bench_message whose blake2s fills 2^log_n rows: whole
    64-byte blocks, each 294 lookup rows or fewer, 16 rows to spare."""
    return 64 * (((1 << log_n) - 16) // BLAKE2S_ROWS_PER_BLOCK)


def _hash_circuit(hash_fn, message: bytes, block: int, rows_per_block: int):
    """The hash circuit of `message` at the sha256 geometry and lookups, its
    capacity the rows its blocks can take (2^18 at least, as the JAX tests
    give)."""
    rows = (len(message) // block + 1) * rows_per_block + 16
    cs = ConstraintSystem(SHA256_GEOMETRY, max(1 << 18, 1 << (rows - 1).bit_length()),
                          lookup_params=SHA256_LOOKUP)
    return cs, hash_fn(cs, allocate_u8_input(cs, message))


def build_keccak256(log_n: int | None = None, message: bytes | None = None):
    """keccak256 of `message`; else, with log_n, of the bench_message that
    fills 2^log_n rows (log_n >= 18); else of the JAX test's message.
    Returns (cs, the 32 digest byte variables)."""
    if message is None:
        message = (b"hello TPU keccak" if log_n is None
                   else bench_message(keccak256_message_len(log_n)))
    return _hash_circuit(keccak256, message, 136, KECCAK_ROWS_PER_BLOCK)


def build_blake2s(log_n: int | None = None, message: bytes | None = None):
    """blake2s of `message`; else, with log_n, of the bench_message that
    fills 2^log_n rows (log_n >= 17); else of the JAX test's message.
    Returns (cs, the 32 digest byte variables)."""
    if message is None:
        message = (b"hello TPU blake2s" if log_n is None
                   else bench_message(blake2s_message_len(log_n)))
    return _hash_circuit(blake2s, message, 64, BLAKE2S_ROWS_PER_BLOCK)


GATE_ZOO_GEOMETRY = CSGeometry(
    num_columns_under_copy_permutation=24,
    num_witness_columns=0,
    num_constant_columns=10,
    max_allowed_constraint_degree=8,
)


ZOO_GATES = ("BoundedGateWrapper", "ByteTriAddGate", "ConditionalSwapGate", "DotProductGate",
             "ExplicitConstantsAllocatorGate", "FmaGate", "MatrixMultiplicationGate",
             "ParallelSelectionGate", "PublicInputGate", "QuadraticCombinationGate",
             "ReductionByPowersGate", "SimpleNonlinearityGate", "U32TriAddCarryAsChunkGate")


def port_zoo_namespace():
    """The classes `gate_zoo` takes, from this package."""
    return SimpleNamespace(ConstraintSystem=ConstraintSystem, CSGeometry=CSGeometry,
                           Boolean=Boolean, Num=Num, UInt8=UInt8, UInt16=UInt16,
                           UInt32=UInt32, **{name: getattr(gates, name) for name in ZOO_GATES})


ZOO_FIRST_ROUND_ROWS, ZOO_ROWS_PER_ROUND = 120, 118  # the most rows a round takes


def gate_zoo(m, log_n: int | None = None, seed: int = 5):
    """Every gate of simple.py and u32.py placed at least once, over the
    classes of namespace `m` (ConstraintSystem, CSGeometry, ZOO_GATES and
    the Boolean, Num and UInt gadgets, under their names;
    `port_zoo_namespace` gives this package's), on values drawn by numpy
    seed `seed`: one round (2^7 rows), or with log_n (8 or more) as many
    as fill 2^log_n rows. The rounds' folded results, folded, are the public
    input. Without lookups the UInt gadgets range-check by booleans.
    Returns (cs, public input variable)."""
    rounds = 1 + (0 if log_n is None else max(
        0, ((1 << log_n) - 16 - ZOO_FIRST_ROUND_ROWS) // ZOO_ROWS_PER_ROUND))
    cs = m.ConstraintSystem(m.CSGeometry(*dataclasses.astuple(GATE_ZOO_GEOMETRY)),
                            1 << (log_n or 7))
    rng = np.random.default_rng(seed)
    # one matrix for every round: the gate's name stands for its matrix
    matrix = rng.integers(0, 1 << 63, (3, 3), dtype=np.uint64)
    mds = m.MatrixMultiplicationGate("zoo3", [[int(v) for v in row] for row in matrix])
    folded = [_zoo_round(m, cs, rng, mds) for _ in range(rounds)]
    if rounds > 1:
        folded = [m.Num.linear_combination(cs, folded, list(range(1, rounds + 1)))]
    m.PublicInputGate.place(cs, folded[0].var)
    return cs, folded[0].var


def _zoo_round(m, cs, rng, mds):
    rand = lambda bits: int(rng.integers(0, 1 << bits, dtype=np.uint64))  # noqa: E731
    # Boolean: and, or, xor, not, select (boolean, fma, selection gates)
    a, b = m.Boolean.allocate(cs, True), m.Boolean.allocate(cs, False)
    flags = [a.and_(cs, b), a.or_(cs, b), a.xor(cs, b), b.negate(cs)]
    flag = m.Boolean.select(cs, a, m.Boolean.multi_or(cs, flags), b)
    # Num: arithmetic, equality (zero check), linear combinations
    # (reduction), bits (boolean, reduction), select, mask
    x, y = m.Num.allocate(cs, rand(63)), m.Num.allocate(cs, rand(63))
    s = x.add(cs, y).mul(cs, x.sub(cs, y))
    eq = x.equals(cs, y).or_(cs, s.is_zero(cs))
    lc = m.Num.linear_combination(cs, [x, y, s, m.Num.allocate(cs, 5), x],
                                  [1, 2, 3, 4, rand(60)])
    bits = m.Num.allocate(cs, rand(10)).spread_into_bits(cs, 10)
    acc = m.Num.select(cs, flag, lc, s.mask(cs, eq)).add_constant(cs, len(bits))
    zero, one = cs.zero_var(), cs.one_var()
    acc = acc.var
    acc = m.ReductionByPowersGate.reduce(cs, [acc, x.var, y.var, bits[3].var], rand(40))
    outs = m.ParallelSelectionGate.select(cs, a.var, [acc, x.var, y.var, s.var],
                                          [y.var, acc, s.var, x.var])
    u, v = m.ConditionalSwapGate.swap(cs, b.var, outs[0], outs[1])
    acc = m.DotProductGate.dot(cs, [(u, v), (outs[2], outs[3]), (x.var, y.var), (acc, one)])
    neg_v = m.Num(zero).sub(cs, m.Num(v)).var
    m.QuadraticCombinationGate.enforce(cs, [(u, v), (u, neg_v), (acc, zero), (one, zero)])
    bounded = m.BoundedGateWrapper(m.FmaGate.instance(), max_rows=1)
    d = cs.alloc_variable_with_value(
        (cs.get_value(acc) * cs.get_value(u) + cs.get_value(v)) % gl.P)
    bounded.place(cs, [acc, u, v, d], (1, 1))
    acc = m.SimpleNonlinearityGate.apply(cs, d, rand(20))
    state = mds.apply(cs, [acc, u, v])
    explicit = m.ExplicitConstantsAllocatorGate.allocate(cs, (5, 1 << 32))
    # UInt: add (u32 add, uint8 and uint16 add), sub, fma, bytes
    w1, w2 = m.UInt32.allocate_checked(cs, rand(32)), m.UInt32.allocate_checked(cs, rand(32))
    total, carry = w1.add(cs, w2)
    diff, borrow = w1.sub(cs, w2)
    low, high = w1.fma(cs, w2, total)
    small = [m.UInt8.allocate_checked(cs, rand(8)) for _ in range(4)]
    b8, _c8 = small[0].add(cs, small[1])
    h16, _c16 = m.UInt16.allocate_checked(cs, rand(16)).add(
        cs, m.UInt16.allocate_checked(cs, rand(16)))
    word = m.UInt32.from_be_bytes(cs, small)
    le = word.to_le_bytes(cs)
    tri_low, tri_high = m.U32TriAddCarryAsChunkGate.add(cs, low.var, high.var, diff.var)
    out4, tri_carry = m.ByteTriAddGate.add(cs, [e.var for e in le],
                                           [e.var for e in small], [b8.var, one, zero, zero])
    parts = (*state, explicit[5], explicit[1 << 32], carry.var, borrow.var, h16.var,
             tri_low, tri_high, *out4, tri_carry)
    return m.Num.linear_combination(cs, [m.Num(v) for v in parts],
                                    list(range(1, len(parts) + 1)))


def build_gate_zoo(log_n: int | None = None, seed: int = 5):
    """The gate zoo over this package's classes (`gate_zoo`)."""
    return gate_zoo(port_zoo_namespace(), log_n, seed)


def gate_zoo_proof_config() -> ProofConfig:
    return ProofConfig(fri_lde_factor=8, merkle_tree_cap_size=4, num_queries=8,
                       pow_bits=0, fri_final_degree=8)


# secp256k1: y^2 = x^3 + 7 over p = 2^256 - 2^32 - 977, its generator G
SECP256K1_B = 7
SECP256K1_G = (0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
               0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8)
# the most rows the ladder's fixed part (G checked on the curve, the affine
# result, the padding) and a step take (tests/port/test_torch_nnf_curves.py)
LADDER_FIXED_ROWS, LADDER_ROWS_PER_STEP = 600, 1310


def secp256k1_ladder_steps(log_n: int) -> int:
    """Ladder steps that fill 2^log_n rows."""
    return ((1 << log_n) - LADDER_FIXED_ROWS) // LADDER_ROWS_PER_STEP


def port_ladder_namespace():
    """The classes `secp256k1_ladder` takes, from this package."""
    return SimpleNamespace(ConstraintSystem=ConstraintSystem, CSGeometry=CSGeometry,
                           LookupParameters=LookupParameters, Boolean=Boolean,
                           NonNativeField=NonNativeField, SWProjectivePoint=SWProjectivePoint,
                           SECP256K1_BASE=SECP256K1_BASE)


def ladder_scalar(steps: int, seed: int) -> int:
    """The scalar of `steps` bits, its top bit set, drawn by numpy seed
    `seed`."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, steps, dtype=np.int64)
    return int("".join(str(int(b)) for b in bits), 2) | (1 << (steps - 1))


def secp256k1_ladder(m, log_n: int | None = None, seed: int = 17):
    """[k]G on secp256k1 by double-and-add over the classes of namespace
    `m` (ConstraintSystem, CSGeometry, LookupParameters, Boolean,
    NonNativeField, SWProjectivePoint, SECP256K1_BASE under their names;
    `port_ladder_namespace` gives this package's). G is allocated, checked
    on the curve, and the ladder starts from the identity; each step, from
    k's top bit down, takes the bit as a Boolean, doubles, adds G (mixed
    addition) and selects X, Y and Z on the bit. The result is converted to
    affine coordinates. At sha256's geometry and lookups; log_n None: two
    steps, 2^12 rows (the TriXor4 table's 4096), else as many steps as fill
    2^log_n rows.
    Returns (cs, SimpleNamespace(x, y, at_infinity, scalar))."""
    steps = 2 if log_n is None else secp256k1_ladder_steps(log_n)
    k = ladder_scalar(steps, seed)
    cs = m.ConstraintSystem(m.CSGeometry(*dataclasses.astuple(SHA256_GEOMETRY)),
                            1 << (log_n or 12),
                            lookup_params=m.LookupParameters(*dataclasses.astuple(SHA256_LOOKUP)))
    params = m.SECP256K1_BASE
    gx = m.NonNativeField.allocate_checked(cs, SECP256K1_G[0], params)
    gy = m.NonNativeField.allocate_checked(cs, SECP256K1_G[1], params)
    m.SWProjectivePoint.from_xy_unchecked(cs, gx, gy, SECP256K1_B).enforce_on_curve(cs)
    acc = m.SWProjectivePoint.zero(cs, params, SECP256K1_B)
    for i in reversed(range(steps)):
        bit = m.Boolean.allocate(cs, bool((k >> i) & 1))
        doubled = acc.double(cs)
        added = doubled.add_mixed(cs, gx, gy)
        acc = m.SWProjectivePoint(
            *(m.NonNativeField.select(cs, bit, getattr(added, c), getattr(doubled, c))
              for c in "xyz"), SECP256K1_B)
    (x, y), at_inf = acc.convert_to_affine_or_default(cs, 0, 0)
    return cs, SimpleNamespace(x=x, y=y, at_infinity=at_inf, scalar=k)


def build_secp256k1_ladder(log_n: int | None = None, seed: int = 17):
    """The secp256k1 ladder over this package's classes (`secp256k1_ladder`)."""
    return secp256k1_ladder(port_ladder_namespace(), log_n, seed)


def secp256k1_mul_host(k: int):
    """[k]G in affine coordinates by plain integer arithmetic (None: the
    identity)."""
    p = SECP256K1_BASE.modulus

    def add(a, b):
        if a is None or b is None:
            return b if a is None else a
        if a[0] == b[0] and (a[1] + b[1]) % p == 0:
            return None
        if a == b:
            lam = 3 * a[0] * a[0] * pow(2 * a[1], -1, p) % p
        else:
            lam = (b[1] - a[1]) * pow(b[0] - a[0], -1, p) % p
        x = (lam * lam - a[0] - b[0]) % p
        return x, (lam * (a[0] - x) - a[1]) % p

    out = None
    for i in reversed(range(k.bit_length())):
        out = add(out, out)
        if (k >> i) & 1:
            out = add(out, SECP256K1_G)
    return out


def secp256k1_ladder_proof_config() -> ProofConfig:
    """The CPU tests' config of the ladder at 2^12 (LDE 2)."""
    return ProofConfig(fri_lde_factor=2, merkle_tree_cap_size=4, num_queries=8,
                       pow_bits=0, fri_final_degree=8)


def build_poseidon_rf(num_rounds: int = 48, capacity: int = 1 << 10, seed: int = 11,
                      field: str = "goldilocks"):
    """The JAX package's examples.py build_poseidon_rf_circuit: a width-3
    state (3, 5, 7); a round an S-box y = x^7 + c per lane, c drawn by numpy
    seed `seed` from [1, 997), then the circulant MDS circ(2, 1, 1); the
    first lane of the result is the public input. Returns (cs, out_var)."""
    cs = ConstraintSystem(XOR_GEOMETRY, capacity, field=field)
    rng = np.random.default_rng(seed)
    mds = MatrixMultiplicationGate("rf3", [[2, 1, 1], [1, 2, 1], [1, 1, 2]], field)
    state = [cs.alloc_variable_with_value(v) for v in (3, 5, 7)]
    for _ in range(num_rounds):
        sboxed = [SimpleNonlinearityGate.apply(cs, x, int(rng.integers(1, 997)))
                  for x in state]
        state = mds.apply(cs, sboxed)
    PublicInputGate.place(cs, state[0])
    return cs, state[0]


def poseidon_rf_proof_config() -> ProofConfig:
    """The JAX package's tests/test_bb_full_prover.py config (LDE 2)."""
    return ProofConfig(fri_lde_factor=2, num_queries=8, fri_final_degree=8)


# the JAX tests' tests/test_e2e.py geometry of the Fibonacci chain
FIBONACCI_GEOMETRY = (8, 0, 6, 4)
# Era's recursion layer (tests/test_recursion.py): a flattened permutation a row
RECURSION_GEOMETRY = CSGeometry(
    num_columns_under_copy_permutation=130,
    num_witness_columns=0,
    num_constant_columns=8,
    max_allowed_constraint_degree=7,
)


def recursion_geometry() -> CSGeometry:
    return RECURSION_GEOMETRY


def port_recursion_namespace():
    """The classes `fibonacci` and `recursion` take, from this package."""
    from .gadgets.recursion import recursive_verify

    return SimpleNamespace(ConstraintSystem=ConstraintSystem, CSGeometry=CSGeometry,
                           BooleanConstraintGate=BooleanConstraintGate, FmaGate=FmaGate,
                           SelectionGate=SelectionGate, PublicInputGate=PublicInputGate,
                           recursive_verify=recursive_verify)


def fibonacci(m, steps: int = 20):
    """The JAX tests' tests/test_e2e.py build_fibonacci_circuit over the
    classes of namespace `m`: x_(i+1) = x_i·x_(i-1) + x_i from (1, 2), a
    boolean flag selecting the last value, which is the public input.
    Returns (cs, the selected variable)."""
    cs = m.ConstraintSystem(m.CSGeometry(*FIBONACCI_GEOMETRY), 1 << 10)
    a = cs.alloc_variable_with_value(1)
    b = cs.alloc_variable_with_value(2)
    flag = cs.alloc_variable_with_value(1)
    m.BooleanConstraintGate.enforce(cs, flag)
    for _ in range(steps):
        a, b = b, m.FmaGate.fma(cs, a, b, a, 1, 1)
    sel = m.SelectionGate.select(cs, flag, a, b)
    m.PublicInputGate.place(cs, sel)
    return cs, sel


def recursion_inner_config(transcript: str = "poseidon2") -> ProofConfig:
    """The JAX tests' config of the inner Fibonacci proof (LDE 8, 8 queries)."""
    return ProofConfig(fri_lde_factor=8, merkle_tree_cap_size=4, num_queries=8, pow_bits=0,
                       fri_final_degree=4, transcript=transcript)


def recursion(m, inner_vk, inner_proofs, inner_gates, log_n: int | None = None):
    """The recursion circuit over the classes of namespace `m`
    (ConstraintSystem, CSGeometry, PublicInputGate, recursive_verify): each
    of `inner_proofs` (of one key `inner_vk` and gates `inner_gates`)
    verified in turn, its public inputs placed as the circuit's own, as the
    JAX package's tests/test_recursion.py places them. Capacity 2^log_n
    rows (None: 2^16). Returns the constraint system."""
    cs = recursion_cs(m, log_n)
    for proof in inner_proofs:
        verify_into(m, cs, inner_vk, proof, inner_gates)
    return cs


def recursion_cs(m, log_n: int | None = None):
    """An empty constraint system of the recursion geometry, capacity
    2^log_n rows (None: 2^16)."""
    return m.ConstraintSystem(m.CSGeometry(*dataclasses.astuple(RECURSION_GEOMETRY)),
                              1 << (log_n or 16))


def verify_into(m, cs, inner_vk, proof, inner_gates):
    """One inner proof verified in `cs`, its public inputs placed as the
    circuit's own."""
    pi_vars, _cap = m.recursive_verify(cs, inner_vk, proof, inner_gates)
    for v in pi_vars:
        m.PublicInputGate.place(cs, v)


def build_recursion(inner_vk, inner_proofs, inner_gates, log_n: int | None = None):
    """The recursion circuit over this package's classes (`recursion`)."""
    return recursion(port_recursion_namespace(), inner_vk, inner_proofs, inner_gates, log_n)


def recursion_inner_count(log_n: int, rows_per_proof: int) -> int:
    """How many inner proofs of `rows_per_proof` rows each (one proof's
    verification with its public inputs, constants included, an upper
    bound for every later one) the recursion circuit takes in 2^log_n
    rows."""
    return (1 << log_n) // rows_per_proof


def hash_gate_proof_config() -> ProofConfig:
    """The JAX package's tests/test_poseidon2_gate.py config of a
    flattened-permutation chain (LDE 8: the gates' quotient degree is 8)."""
    return ProofConfig(fri_lde_factor=8, merkle_tree_cap_size=4, num_queries=6,
                       fri_final_degree=8)


def recursion_small_proof_config() -> ProofConfig:
    """The CPU-sized config of the 130-column circuits (the queue, the
    recursion circuit at 2^10): tests/test_recursion.py's outer config at
    LDE 2, the quotient at its degree 8."""
    return ProofConfig(fri_lde_factor=2, merkle_tree_cap_size=8, num_queries=4, pow_bits=0,
                       fri_final_degree=16)


def build_permutation_chain(legacy: bool = False, steps: int = 8):
    """tests/test_poseidon2_gate.py's chain at the recursion geometry:
    `steps` flattened permutations (legacy Poseidon with `legacy`) from the
    state 0..11, the first output lane the public input. Returns (cs, the
    12 output variables)."""
    from .gadgets import poseidon2_rf, poseidon_rf

    perm = (poseidon_rf if legacy else poseidon2_rf).circuit_permutation
    cs = ConstraintSystem(RECURSION_GEOMETRY, 1 << 10)
    state = [cs.alloc_variable_with_value(i) for i in range(12)]
    for _ in range(steps):
        state = perm(cs, state)
    PublicInputGate.place(cs, state[0])
    return cs, state


def build_queue_roundtrip(items=((1, 2, 3), (4, 5, 6), (7, 8, 9))):
    """tests/test_queue.py's round trip at the recursion geometry with
    width-4 ×8 lookups (the length's range checks): the items pushed, popped
    and the ends tied. Returns (cs, the popped values)."""
    from .gadgets.queue import CircuitQueue

    cs = ConstraintSystem(RECURSION_GEOMETRY, 1 << 14, lookup_params=SHA256_LOOKUP)
    q = CircuitQueue(cs, element_width=len(items[0]))
    for it in items:
        q.push(cs, [cs.alloc_variable_with_value(v) for v in it])
    popped = []
    while q._witness:
        popped.append([cs.get_value(v) for v in q.pop_front(cs)])
    q.enforce_consistency(cs)
    return cs, popped


def build_fibonacci_recursion(transcript: str = "poseidon2", device="cuda"):
    """The recursion circuit over the Fibonacci proof of the JAX tests
    (`fibonacci`, proved on `device` with `recursion_inner_config`), 2^10
    rows. Returns (cs, the inner proof)."""
    from .prover import generate_setup, prove

    cfg = recursion_inner_config(transcript)
    inner = fibonacci(port_recursion_namespace())[0].into_assembly()
    setup = generate_setup(inner, cfg, device=device)
    proof = prove(inner, setup, cfg, device=device)
    return build_recursion(setup.vk, [proof], inner.gates), proof
