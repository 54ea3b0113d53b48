"""boojum_tpu_torch's sha256 circuit against boojum_tpu's on the CPU: the
digest against hashlib, the assembly of sha256(b"abc") (2^14 rows, bench.py's
geometry and lookups) word for word (tolerance 0: exact field elements), and
one coset of the quotient sweep at that geometry against the JAX package's
sweep core."""

import dataclasses
import hashlib
from types import SimpleNamespace

import numpy as np
import pytest

from boojum_tpu.cs.implementations import ConstraintSystem as JConstraintSystem
from boojum_tpu.cs.types import CSGeometry as JCSGeometry
from boojum_tpu.cs.types import LookupParameters as JLookupParameters
from boojum_tpu.gadgets import allocate_u8_input as jallocate_u8_input
from boojum_tpu.gadgets import sha256 as jsha256
from boojum_tpu.prover.setup import build_constant_columns, build_selector_tree
from boojum_tpu.prover.setup import non_residues_for_copy_permutation
from boojum_tpu_torch.circuits import (
    SHA256_GEOMETRY, SHA256_LOOKUP, build_sha256, sha256_proof_config,
)
from boojum_tpu_torch.gadgets import sha256_digest_bytes
from boojum_tpu_torch.prover.setup import build_selector_tree as tbuild_selector_tree
from torch_port_util import sweep_against_jax

MESSAGE = b"abc"


@pytest.fixture(scope="module")
def jax_abc():
    cs = JConstraintSystem(JCSGeometry(60, 0, 8, 7), 1 << 17,
                           lookup_params=JLookupParameters(width=4, num_repetitions=8))
    digest = jsha256(cs, jallocate_u8_input(cs, MESSAGE))
    asm = cs.into_assembly()
    assert bytes(cs.get_value(v) for v in digest) == hashlib.sha256(MESSAGE).digest()
    _tree, paths = build_selector_tree(asm.gates)
    consts = np.concatenate([build_constant_columns(asm, paths),
                             asm.lookup_table_id_col[None, :]])
    setup = SimpleNamespace(selector_paths=paths, constant_cols=consts,
                            non_residues=non_residues_for_copy_permutation(92))
    return SimpleNamespace(asm=asm, setup=setup)


@pytest.fixture(scope="module")
def port_abc():
    cs, digest = build_sha256(message=MESSAGE)
    return SimpleNamespace(cs=cs, digest=digest, asm=cs.into_assembly())


def test_geometry_and_config_are_bench_py():
    assert dataclasses.astuple(SHA256_GEOMETRY) == (60, 0, 8, 7)
    assert (SHA256_LOOKUP.width, SHA256_LOOKUP.num_repetitions) == (4, 8)
    assert SHA256_LOOKUP.use_specialized_columns
    assert dataclasses.asdict(sha256_proof_config()) == dict(
        fri_lde_factor=8, merkle_tree_cap_size=16, num_queries=50, pow_bits=0,
        fri_final_degree=16, fri_folding_schedule=None, quotient_degree=None,
        transcript="poseidon2")


@pytest.mark.parametrize("message", [b"", b"abc", bytes(range(100))],
                         ids=["empty", "abc", "range100"])
def test_digest_matches_hashlib(message):
    cs, digest = build_sha256(message=message)
    assert sha256_digest_bytes(cs, digest) == hashlib.sha256(message).digest()


ARRAYS = ("copy_placement", "copy_cols_values", "lookup_placement",
          "lookup_cols_values", "lookup_table_id_col", "multiplicities", "row_gate")


@pytest.mark.parametrize("name", ARRAYS)
def test_abc_assembly_arrays_match_jax(jax_abc, port_abc, name):
    np.testing.assert_array_equal(getattr(port_abc.asm, name), getattr(jax_abc.asm, name))


def test_abc_assembly_shape_matches_jax(jax_abc, port_abc):
    ja, ta = jax_abc.asm, port_abc.asm
    assert ta.trace_len == ja.trace_len == 1 << 14
    assert [g.name for g in ta.gates] == [g.name for g in ja.gates] == [
        "constant", "fma", "reduction4", "nop"]
    assert ta.gate_constants == ja.gate_constants
    assert ta.public_inputs == ja.public_inputs == []
    assert ta.num_lookup_cols == ja.num_lookup_cols == 32
    assert ta.num_lookup_tables == len(ja.lookup_tables) == 5
    np.testing.assert_array_equal(ta.stacked_table_columns(4), ja.stacked_table_columns(4))
    _tree, paths = tbuild_selector_tree(ta.gates)
    assert paths == jax_abc.setup.selector_paths


def test_sweep_plain_matches_jax_u64_core_at_sha_geometry(jax_abc):
    sweep_against_jax(jax_abc.asm, jax_abc.setup, 2, 32)
