"""boojum_tpu_torch's keccak256 and blake2s circuits against boojum_tpu's on
the CPU, at the messages of the JAX package's tests/test_keccak.py and
tests/test_blake2s.py, one block and two (the sha256 geometry and lookups:
2^18 rows for keccak256, 2^17 for blake2s):

- the digests against hashes/keccak_host.py (a copy of the JAX package's
  host Keccak) and hashlib;
- the assemblies word for word (tolerance 0: exact field elements): gate
  order and placement, copy columns and gate constants, lookup placement and
  values, table ids, stacked tables and multiplicities;
- prover/satisfiability.py's check against the JAX package's: True on both,
  and False on both with one copy cell of an fma row changed.

Each circuit is synthesized once a module by each package."""

import copy
import hashlib
from types import SimpleNamespace

import numpy as np
import pytest

from boojum_tpu.cs.implementations import ConstraintSystem as JConstraintSystem
from boojum_tpu.cs.types import CSGeometry as JCSGeometry
from boojum_tpu.cs.types import LookupParameters as JLookupParameters
from boojum_tpu.gadgets import allocate_u8_input as jallocate_u8_input
from boojum_tpu.gadgets.blake2s import blake2s as jblake2s
from boojum_tpu.gadgets.keccak256 import keccak256 as jkeccak256
from boojum_tpu.hashes.keccak_host import keccak256 as jhost_keccak256
from boojum_tpu.prover.satisfiability import check_if_satisfied as jcheck
from boojum_tpu_torch.circuits import (
    BLAKE2S_ROWS_PER_BLOCK, KECCAK_ROWS_PER_BLOCK, blake2s_message_len, build_blake2s,
    build_keccak256, keccak256_message_len,
)
from boojum_tpu_torch.gadgets import blake2s_digest_bytes, keccak256_digest_bytes
from boojum_tpu_torch.hashes.keccak_host import keccak256 as host_keccak256
from boojum_tpu_torch.prover.satisfiability import check_if_satisfied
from torch_port_util import assert_same_assembly

P = 0xFFFFFFFF00000001
# the JAX tests' messages: one block and two
CASES = {
    "keccak256-1": (b"hello TPU keccak", build_keccak256, jkeccak256, host_keccak256),
    "keccak256-2": (bytes(range(150)), build_keccak256, jkeccak256, host_keccak256),
    "blake2s-1": (b"hello TPU blake2s", build_blake2s, jblake2s,
                  lambda m: hashlib.blake2s(m).digest()),
    "blake2s-2": (bytes(range(100)), build_blake2s, jblake2s,
                  lambda m: hashlib.blake2s(m).digest()),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def circuit(request):
    message, build, jhash, host = CASES[request.param]
    jcs = JConstraintSystem(JCSGeometry(60, 0, 8, 7), 1 << 18,
                            lookup_params=JLookupParameters(width=4, num_repetitions=8))
    jdigest = jhash(jcs, jallocate_u8_input(jcs, message))
    tcs, tdigest = build(message=message)
    return SimpleNamespace(
        name=request.param, want=host(message),
        jdigest=bytes(int(jcs.get_value(v)) for v in jdigest),
        tdigest=(keccak256_digest_bytes if request.param.startswith("keccak")
                 else blake2s_digest_bytes)(tcs, tdigest),
        ja=jcs.into_assembly(), ta=tcs.into_assembly())


def test_host_keccak_matches_jax_and_known_vectors():
    assert host_keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
    assert host_keccak256(b"abc").hex() == (
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45")
    rng = np.random.default_rng(7)
    for size in (0, 1, 135, 136, 137, 300):
        m = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        assert host_keccak256(m) == jhost_keccak256(m), size


def test_digests_match_host(circuit):
    assert circuit.tdigest == circuit.jdigest == circuit.want


def test_assembly_matches_jax(circuit):
    assert circuit.ta.trace_len == 1 << (18 if circuit.name.startswith("keccak") else 17)
    assert_same_assembly(circuit.ta, circuit.ja)


def test_satisfiability_matches_jax(circuit):
    ta, ja = circuit.ta, circuit.ja
    assert check_if_satisfied(ta) and jcheck(ja)
    # one copy cell of the first fma row, changed by 1 in both assemblies
    fma = [g.name for g in ta.gates].index("fma")
    row = int(np.nonzero(ta.row_gate == fma)[0][0])
    bad_t, bad_j = copy.copy(ta), copy.copy(ja)
    for bad in (bad_t, bad_j):
        bad.copy_cols_values = bad.copy_cols_values.copy()
        bad.copy_cols_values[3, row] = (int(bad.copy_cols_values[3, row]) + 1) % P
    assert not check_if_satisfied(bad_t) and not jcheck(bad_j)


@pytest.mark.parametrize("blocks", [1, 3])
def test_message_rules_leave_rows_to_spare(blocks):
    """The rules that size a message to 2^log_n rows count at least the
    lookup rows each block takes: blocks of a message take no more than
    that many rows a block, with 16 rows to spare."""
    for build, block, per_block in ((build_keccak256, 136, KECCAK_ROWS_PER_BLOCK),
                                    (build_blake2s, 64, BLAKE2S_ROWS_PER_BLOCK)):
        cs, _digest = build(message=bytes(block * blocks - 1))
        per_table = {}
        for tid, _places in cs.lookup_rows:
            per_table[tid] = per_table.get(tid, 0) + 1
        rows = sum(-(-c // 8) for c in per_table.values())
        assert rows <= blocks * per_block + 16
    assert keccak256_message_len(18) == 136 * 84 - 1
    assert blake2s_message_len(17) == 64 * 445
