"""Each CUDA kernel of boojum_tpu_torch against its plain PyTorch version on
the card, word for word (tolerance 0), the quotient sweep in every layout
(the keccak256, blake2s, gate-zoo and secp256k1-ladder circuits included)
and through its
standalone entries (gate_terms_fn at every gate of cs/gates/simple.py and
cs/gates/u32.py, the 12×12 matrix gate included), and the fma 2^10, xor4
lookup 2^9, general-lookup 2^9 and witness-column 2^5 proofs identical on
the card and the CPU, materialized and streamed; kernel B8 (BabyBear
Poseidon2) and the BabyBear fma, xor4 and mini-STARK proofs at 2^10
likewise; B6 over the flattened Poseidon2 and Poseidon gates and the
extension FMA gate in one launch (a program read from global memory), and
the recursion circuit over a Fibonacci proof at 2^10, under both
transcripts, identical on the card and the CPU. Marked `cuda`: they skip
where no card is present and run on the card with
`python -m pytest tests/port/test_torch_kernels.py`."""

import functools

import numpy as np
import pytest
import torch

from boojum_tpu_torch import circuits
from boojum_tpu_torch.circuits import (
    build_blake2s, build_fma, build_gate_zoo, build_general_lookup, build_keccak256,
    build_secp256k1_ladder, build_sha256, build_xor_lookup, build_zero_check_witness,
    fma_proof_config, small_proof_config, xor_lookup_proof_config,
)
from boojum_tpu_torch.cs.gates import (
    ExtFmaGate, Poseidon2FlattenedGate, PoseidonFlattenedGate, simple, u32,
)
from boojum_tpu_torch.cs.types import CSGeometry
from boojum_tpu_torch.field import goldilocks as gf
from boojum_tpu_torch.hashes import poseidon2 as p2
from boojum_tpu_torch.ntt import ntt
from boojum_tpu_torch.prover import ProofConfig, fri, generate_setup, prove, verify
from boojum_tpu_torch.prover import quotient_sweep as qs
from boojum_tpu_torch.prover.setup import build_selector_tree

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(rng, *shape, device):
    w = rng.integers(0, gf.P, size=shape, dtype=np.uint64)
    return gf.from_numpy(w, device)


def _same(a, b):
    np.testing.assert_array_equal(gf.to_numpy(a), gf.to_numpy(b))


@pytest.mark.parametrize("L", [1, 4, 8])
@pytest.mark.parametrize("log_n", [1, 5, 11, 12, 16, 17, 20, 21, 22, 23])
def test_ntt_kernels_match_plain(dev, log_n, L):
    """B1-B3 against their plain versions at the sizes where the forward
    kernel's pass plan changes (one pass up to 2^11, two up to 2^21, three
    beyond), each with a coset scale row and an LDE into L cosets."""
    rng = np.random.default_rng(log_n)
    a = _rand(rng, 3 if log_n <= 20 else 2, 1 << log_n, device=dev)
    scale = ntt.lde_scale_rows(log_n, L, dev)
    row = scale[L - 1]
    _same(ntt.fft_natural_to_bitreversed(a, row), ntt.fft_plain(a, row))
    _same(ntt.lde_from_monomial(a, L), ntt.lde_plain(a, scale))
    if L == 1:
        _same(ntt.fft_natural_to_bitreversed(a), ntt.fft_plain(a))
        _same(ntt.ifft_bitreversed_to_natural(a), ntt.ifft_plain(a))


@pytest.mark.parametrize("width", [1, 8, 9, 16, 22])
def test_poseidon2_kernels_match_plain(dev, width):
    rng = np.random.default_rng(width)
    cols = _rand(rng, width, 1000, device=dev)
    _same(p2.leaf_hash(cols), p2.leaf_hash_plain(cols))
    layer = _rand(rng, 512, 4, device=dev)
    _same(p2.node_hash(layer), p2.node_hash_plain(layer))


def _filled(rng, fill, *shape, device):
    """Words of one kind: random canonical, p - 1, 0, or at least 2^63."""
    if fill == "random":
        return _rand(rng, *shape, device=device)
    if fill == "high":
        w = rng.integers(1 << 63, gf.P, size=shape, dtype=np.uint64)
        return gf.from_numpy(w, device)
    v = gf.P - 1 if fill == "p-1" else 0
    return gf.from_numpy(np.full(shape, v, dtype=np.uint64), device)


@pytest.mark.parametrize("fill", ["random", "p-1", "zero", "high"])
@pytest.mark.parametrize("N", [1000, 4097])
@pytest.mark.parametrize("b", [1, 8, 13, 32])
def test_poseidon2_permute_and_absorb_match_plain(dev, b, N, fill):
    """Kernel B4: the bare permutation, and the absorb of a (b, N) block into
    carried states in place, against their plain versions, for N not a
    multiple of the block size and states of boundary words."""
    rng = np.random.default_rng(100 + b)
    state = _filled(rng, fill, N, 12, device=dev)
    _same(p2.poseidon2_permutation(state), p2.permutation_plain(state))
    cols = _filled(rng, fill, b, N, device=dev)
    got = p2.absorb_cols(state.clone(), cols)
    _same(got, p2.absorb_cols_plain(state.clone(), cols))


def test_sweep_and_fold_kernels_match_plain(dev):
    asm = build_fma(8).into_assembly()
    _tree, paths = build_selector_tree(asm.gates)
    plan = qs.SweepPlan(asm.gates, paths, asm.geometry, 16, dev)
    rng = np.random.default_rng(0)
    n = 1 << 10
    args = [_rand(rng, r, n, device=dev) for r in (16, 22, 12, 2)]
    args += [_rand(rng, n, device=dev) for _ in range(3)]
    table = qs.sweep_table(plan, (3, 5), (7, 11), (13, 17), list(range(1, 17)), dev)
    for g, w in zip(qs.coset_terms(plan, *args, table),
                    qs.coset_terms_plain(plan, *args, table)):
        _same(g, w)
    c0, c1, inv_x = (_rand(rng, m, device=dev) for m in (n, n, n // 2))
    for g, w in zip(fri.fold_once(c0, c1, (3, 5), inv_x),
                    fri.fold_once_plain(c0, c1, (3, 5), inv_x)):
        _same(g, w)


def _extreme(rng, n, device):
    """Random canonical words, about half of them 0, 1, p - 1 or p - 2^32."""
    w = rng.integers(0, gf.P, size=n, dtype=np.uint64)
    pick = rng.random(n) < 0.5
    w[pick] = rng.choice(np.array([0, 1, gf.P - 1, gf.P - 2**32], dtype=np.uint64),
                         size=int(pick.sum()))
    return gf.from_numpy(w, device)


@pytest.mark.parametrize("extra", [0, 1, 4, 10, 16])
@pytest.mark.parametrize("k", range(1, 2 * fri.MAX_FOLD_K + 1))
def test_fold_oracle_kernel_matches_plain(dev, k, extra):
    """Kernel B7: k rounds of one oracle from N = 2^(k + extra) points (at
    most 2^16) against fold_oracle_plain, with extreme words in values,
    table and challenges, the challenge 0, and inputs at an odd word offset.
    A k above MAX_FOLD_K takes two launches, the second reading the first
    table at a stride: k up to twice MAX_FOLD_K runs every version the
    kernel is built in."""
    from boojum_tpu_torch import kernels as K

    N = 1 << min(16, k + extra)
    rng = np.random.default_rng(10 * k + extra)
    c0, c1 = _extreme(rng, N, dev), _extreme(rng, N, dev)
    inv_x = _extreme(rng, N // 2, dev)
    chs = [tuple(int(v) for v in gf.to_numpy(_extreme(rng, 2, dev))), (0, 0),
           (gf.P - 1, gf.P - 2**32)]
    for ch in chs:
        subs = fri.sub_challenges(ch, k)
        before = K.LAUNCHES["fri_fold"]
        got = fri.fold_oracle(c0, c1, subs, inv_x)
        assert K.LAUNCHES["fri_fold"] - before == -(-k // fri.MAX_FOLD_K)
        for g, w in zip(got, fri.fold_oracle_plain(c0, c1, subs, inv_x)):
            _same(g, w)
    # views one word into a buffer: not 16-byte aligned
    odd = [_extreme(rng, m + 1, dev)[1:] for m in (N, N, N // 2)]
    assert all(t.data_ptr() % 16 == 8 for t in odd)
    for g, w in zip(fri.fold_oracle(*odd[:2], subs, odd[2]),
                    fri.fold_oracle_plain(*odd[:2], subs, odd[2])):
        _same(g, w)


@pytest.mark.parametrize("schedule", [[4, 1], [5, 4, 3]])
def test_fold_chain_at_an_explicit_schedule_matches_plain(dev, schedule):
    """Kernel B7 over a whole FRI chain of an explicit schedule whose entries
    of 4 and 5 rounds split into two launches, each entry from its first
    round's table (fold_entry_tables), from 2^(folds + 4) points, against
    fold_oracle_plain entry by entry."""
    from boojum_tpu_torch import kernels as K

    log_full = sum(schedule) + 4
    rng = np.random.default_rng(sum(schedule))
    tables = fri.fold_entry_tables(log_full, schedule, dev)
    c0, c1 = _extreme(rng, 1 << log_full, dev), _extreme(rng, 1 << log_full, dev)
    p0, p1 = c0, c1
    for r, k in enumerate(schedule):
        subs = fri.sub_challenges((3 + r, gf.P - 1 - r), k)
        before = K.LAUNCHES["fri_fold"]
        c0, c1 = fri.fold_oracle(c0, c1, subs, tables[r])
        assert K.LAUNCHES["fri_fold"] - before == -(-k // fri.MAX_FOLD_K)
        p0, p1 = fri.fold_oracle_plain(p0, p1, subs, tables[r])
        _same(c0, p0)
        _same(c1, p1)
    assert c0.shape[0] == 1 << 4


@pytest.mark.parametrize("circuit", ["xor4", "sha256"])
def test_lookup_sweep_kernel_matches_plain(dev, circuit):
    """The sweep with its lookup terms, at the xor4 (width 3, 2 sub-arguments)
    and sha256 (width 4, 8 sub-arguments, 92 copy columns) geometries."""
    cs = build_xor_lookup()[0] if circuit == "xor4" else build_sha256(message=b"abc")[0]
    asm = cs.into_assembly()
    _tree, paths = build_selector_tree(asm.gates)
    Ct = asm.num_copy_cols_total
    plan = qs.SweepPlan(asm.gates, paths, asm.geometry, Ct, dev, asm.lookup_params)
    rng = np.random.default_rng(2)
    n = 1 << 11
    args = [_rand(rng, r, n, device=dev)
            for r in (plan.num_wit_rows, plan.num_setup_cols, plan.num_s2_rows, 2)]
    args += [_rand(rng, n, device=dev) for _ in range(3)]
    table = qs.sweep_table(plan, (3, 5), (7, 11), (13, 17), list(range(1, Ct + 1)), dev,
                           (19, 23), (29, 31))
    for g, w in zip(qs.coset_terms(plan, *args, table),
                    qs.coset_terms_plain(plan, *args, table)):
        _same(g, w)


@pytest.mark.parametrize("circuit", ["general", "witness"])
def test_sweep_kernel_matches_plain_in_the_new_layouts(dev, circuit):
    """The sweep with general-mode lookup terms (width 3, 2 sub-arguments on
    marker rows) and with witness-column loads (4 witness columns)."""
    cs = build_general_lookup()[0] if circuit == "general" else build_zero_check_witness()[0]
    asm = cs.into_assembly()
    _tree, paths = build_selector_tree(asm.gates)
    Ct = asm.num_copy_cols_total
    lp = asm.lookup_params if asm.lookups_enabled else None
    plan = qs.SweepPlan(asm.gates, paths, asm.geometry, Ct, dev, lp)
    rng = np.random.default_rng(3)
    n = 1 << 11
    args = [_rand(rng, r, n, device=dev)
            for r in (plan.num_wit_rows, plan.num_setup_cols, plan.num_s2_rows, 2)]
    args += [_rand(rng, n, device=dev) for _ in range(3)]
    table = qs.sweep_table(plan, (3, 5), (7, 11), (13, 17), list(range(1, Ct + 1)), dev,
                           (19, 23), (29, 31))
    for g, w in zip(qs.coset_terms(plan, *args, table),
                    qs.coset_terms_plain(plan, *args, table)):
        _same(g, w)


@pytest.mark.parametrize("entry", ["gate_terms_fn", "cp_quotient", "lookup_quotient",
                                   "lookup_quotient_general"])
def test_sweep_entry_kernel_matches_plain(dev, entry):
    rng = np.random.default_rng(4)
    n = 1 << 11
    r = lambda *shape: _rand(rng, *shape, device=dev)  # noqa: E731
    pows = lambda k: [(3 + i, 5 + i) for i in range(k)]  # noqa: E731
    if entry == "gate_terms_fn":
        asm = build_zero_check_witness()[0].into_assembly()
        _tree, paths = build_selector_tree(asm.gates)
        launch = qs.gate_terms_fn(asm.gates, paths, asm.geometry, dev).launch
        args = (r(8, n), r(4, n), r(6, n), pows(qs.num_gate_terms(asm.gates, asm.geometry)))
    elif entry == "cp_quotient":
        launch = qs.cp_quotient_launch
        args = (r(4, n), r(2, n), r(8, n), r(8, n), r(n), r(n), (3, 5), (7, 11), pows(3),
                list(range(1, 9)), 4)
    elif entry == "lookup_quotient":
        launch = qs.lookup_quotient_launch
        args = (r(18, n), r(32, n), r(n), r(5, n), r(n), (19, 23), (29, 31), pows(9), 8, 4)
    else:
        launch = qs.lookup_quotient_general_launch
        args = (r(6, n), r(6, n), r(n), r(4, n), r(n), r(n), (19, 23), (29, 31), pows(3),
                2, 3)
    built = launch(*args)
    for g, w in zip(qs.sweep(*built), qs.sweep_plain(*built)):
        _same(g, w)


# challenges of each fill: the sweep's lazy sums see their largest words
# with every operand and challenge at p - 1 or at least 2^63
_CHALLENGES = {"random": (3, 7, 13, 19, 29), "p-1": (gf.P - 1,) * 5, "zero": (0,) * 5,
               "high": tuple((1 << 63) + 1000 * i for i in range(5))}


# every instantiation of csrc/quotient_sweep.cu (rows a thread, threads a
# block, sub-threads a row): the extreme-word tests run each, since at their
# sizes launch_geometry would pick the first alone
_GEOMETRIES = [(1, 256, 2), (2, 256, 1), (1, 128, 1)]


@functools.lru_cache(maxsize=None)
def _sweep_circuit(circuit):
    cs = {"fma": lambda: build_fma(8),
          "sha256": lambda: build_sha256(message=b"abc")[0],
          "general": lambda: build_general_lookup()[0],
          "witness": lambda: build_zero_check_witness()[0],
          "keccak256": lambda: build_keccak256()[0],
          "blake2s": lambda: build_blake2s()[0],
          "gate zoo": lambda: build_gate_zoo()[0],
          "secp256k1 ladder": lambda: build_secp256k1_ladder()[0]}[circuit]()
    return cs.into_assembly()


@pytest.mark.parametrize("geometry", _GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
@pytest.mark.parametrize("fill", ["random", "p-1", "zero", "high"])
@pytest.mark.parametrize("circuit", ["fma", "sha256", "general", "witness", "keccak256",
                                     "blake2s", "gate zoo", "secp256k1 ladder"])
def test_sweep_kernel_matches_plain_on_extreme_words(dev, monkeypatch, circuit, fill,
                                                     geometry):
    """The whole sweep with every operand and challenge of one kind, in each
    launch geometry, and at the random fill also at 2^7 rows, fewer than one
    block takes."""
    monkeypatch.setattr(qs, "launch_geometry", lambda n, parts: geometry)
    asm = _sweep_circuit(circuit)
    _tree, paths = build_selector_tree(asm.gates)
    Ct = asm.num_copy_cols_total
    lp = asm.lookup_params if asm.lookups_enabled else None
    plan = qs.SweepPlan(asm.gates, paths, asm.geometry, Ct, dev, lp)
    rng = np.random.default_rng(5)
    a, b, g, lb, lg = _CHALLENGES[fill]
    for n in ((1 << 7, 1 << 11) if fill == "random" else (1 << 11,)):
        args = [_filled(rng, fill, r, n, device=dev)
                for r in (plan.num_wit_rows, plan.num_setup_cols, plan.num_s2_rows, 2)]
        args += [_filled(rng, fill, n, device=dev) for _ in range(3)]
        table = qs.sweep_table(plan, (a, a), (b, b), (g, g), [a] * Ct, dev, (lb, lb),
                               (lg, lg))
        for got, want in zip(qs.coset_terms(plan, *args, table),
                             qs.coset_terms_plain(plan, *args, table)):
            _same(got, want)


@pytest.mark.parametrize("geometry", _GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
@pytest.mark.parametrize("fill", ["p-1", "zero", "high"])
@pytest.mark.parametrize("entry", ["gate_terms_fn", "cp_quotient", "lookup_quotient",
                                   "lookup_quotient_general"])
def test_sweep_entry_kernel_matches_plain_on_extreme_words(dev, monkeypatch, entry, fill,
                                                           geometry):
    monkeypatch.setattr(qs, "launch_geometry", lambda n, parts: geometry)
    rng = np.random.default_rng(6)
    n = 1 << 11
    r = lambda *shape: _filled(rng, fill, *shape, device=dev)  # noqa: E731
    a, b, g, lb, lg = _CHALLENGES[fill]
    pows = lambda k: [(a, a)] * k  # noqa: E731
    if entry == "gate_terms_fn":
        asm = build_zero_check_witness()[0].into_assembly()
        _tree, paths = build_selector_tree(asm.gates)
        launch = qs.gate_terms_fn(asm.gates, paths, asm.geometry, dev).launch
        args = (r(8, n), r(4, n), r(6, n), pows(qs.num_gate_terms(asm.gates, asm.geometry)))
    elif entry == "cp_quotient":
        launch = qs.cp_quotient_launch
        args = (r(4, n), r(2, n), r(8, n), r(8, n), r(n), r(n), (b, b), (g, g), pows(3),
                [a] * 8, 4)
    elif entry == "lookup_quotient":
        launch = qs.lookup_quotient_launch
        args = (r(18, n), r(32, n), r(n), r(5, n), r(n), (lb, lb), (lg, lg), pows(9), 8, 4)
    else:
        launch = qs.lookup_quotient_general_launch
        args = (r(6, n), r(6, n), r(n), r(4, n), r(n), r(n), (lb, lb), (lg, lg), pows(3),
                2, 3)
    built = launch(*args)
    for got, want in zip(qs.sweep(*built), qs.sweep_plain(*built)):
        _same(got, want)


# every gate of cs/gates/simple.py and cs/gates/u32.py with quotient terms,
# the parametrised ones at a few parameters, each alone over 60 copy, 2
# witness and 8 constant columns
_MATRIX12 = [[(i * 12 + j) * 0x9E3779B97F4A7C15 % gf.P for j in range(12)] for i in range(12)]
_GATES = {
    **{name: getattr(simple, name).instance() for name in (
        "FmaGate", "ConstantsAllocatorGate", "BooleanConstraintGate", "ReductionGate",
        "ReductionByPowersGate", "SelectionGate", "ParallelSelectionGate",
        "ConditionalSwapGate", "DotProductGate", "QuadraticCombinationGate", "ZeroCheckGate",
        "ZeroCheckWitnessGate", "SimpleNonlinearityGate")},
    **{name: getattr(u32, name).instance() for name in (
        "U32AddGate", "U32SubGate", "U32FmaGate", "U32TriAddCarryAsChunkGate",
        "ByteTriAddGate")},
    "UIntXAddGate8": u32.UIntXAddGate(8),
    "UIntXAddGate16": u32.UIntXAddGate(16),
    "MatrixMultiplicationGate3": simple.MatrixMultiplicationGate("m3", _MATRIX12[:3]),
    "MatrixMultiplicationGate12": simple.MatrixMultiplicationGate("m12", _MATRIX12),
    "ExplicitConstantsAllocatorGate": simple.ExplicitConstantsAllocatorGate((5, 1 << 32)),
    "BoundedGateWrapper": simple.BoundedGateWrapper(u32.U32FmaGate.instance(), 3),
}


@pytest.mark.parametrize("geometry", _GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
@pytest.mark.parametrize("fill", ["random", "p-1", "high"])
@pytest.mark.parametrize("gate", sorted(_GATES))
def test_gate_terms_kernel_matches_plain_at_every_gate(dev, monkeypatch, gate, fill,
                                                       geometry):
    """gate_terms_fn at each gate's program, as the sweep's slots renumbered
    by liveness encode it, in each launch geometry."""
    monkeypatch.setattr(qs, "launch_geometry", lambda n, parts: geometry)
    g = _GATES[gate]
    geom = CSGeometry(60, 2, 8, 8)
    launch = qs.gate_terms_fn([g], [[]], geom, dev).launch
    rng = np.random.default_rng(7)
    n = 1 << 11
    r = lambda *shape: _filled(rng, fill, *shape, device=dev)  # noqa: E731
    a = _CHALLENGES[fill][0]
    built = launch(r(60, n), r(2, n), r(8, n),
                   [(a + i, a) for i in range(qs.num_gate_terms([g], geom))])
    for got, want in zip(qs.sweep(*built), qs.sweep_plain(*built)):
        _same(got, want)


@pytest.mark.parametrize("log_n", [19, 22, 23])
def test_inverse_ntt_at_a_quotient_row(dev, log_n):
    """B2 at the single rows of Q·n words the provers interpolate the
    quotient from (sha256 2^19, fma 2^22, general and witness 2^23): three
    passes from 2^22."""
    rng = np.random.default_rng(log_n)
    a = _rand(rng, 1, 1 << log_n, device=dev)
    _same(ntt.ifft_bitreversed_to_natural(a), ntt.ifft_plain(a))


def test_sweep_rejects_a_short_setup_stack_on_the_card(dev):
    asm = build_fma(8).into_assembly()
    _tree, paths = build_selector_tree(asm.gates)
    plan = qs.SweepPlan(asm.gates, paths, asm.geometry, 16, dev)
    rng = np.random.default_rng(1)
    n = 1 << 10
    args = [_rand(rng, r, n, device=dev) for r in (16, 17, 12, 2)]
    args += [_rand(rng, n, device=dev) for _ in range(3)]
    table = qs.sweep_table(plan, (3, 5), (7, 11), (13, 17), list(range(1, 17)), dev)
    with pytest.raises(ValueError):
        qs.coset_terms(plan, *args, table)


@pytest.mark.parametrize("circuit", ["fma", "xor4", "general", "witness"])
def test_proof_identical_on_card_and_cpu(dev, circuit):
    if circuit == "fma":
        asm, cfg = build_fma(10).into_assembly(), fma_proof_config()
    elif circuit == "xor4":
        asm, cfg = build_xor_lookup()[0].into_assembly(), xor_lookup_proof_config()
    elif circuit == "general":
        asm, cfg = build_general_lookup()[0].into_assembly(), small_proof_config()
    else:
        asm, cfg = build_zero_check_witness()[0].into_assembly(), small_proof_config()
    s_gpu = generate_setup(asm, cfg, device=dev)
    p_gpu = prove(asm, s_gpu, cfg, device=dev)
    p_cpu = prove(asm, generate_setup(asm, cfg, device="cpu"), cfg, device="cpu")
    assert p_gpu.to_json() == p_cpu.to_json()
    assert verify(s_gpu.vk, p_gpu, asm.gates)


@pytest.mark.parametrize("circuit", ["fma", "general"])
def test_streamed_proof_on_card_matches_cpu(dev, circuit):
    """Every commit streamed on the card (threshold 0, setup too): the
    absorb kernel runs, and the proof is the CPU's materialized one."""
    from boojum_tpu_torch import kernels as K

    if circuit == "fma":
        asm, cfg = build_fma(10).into_assembly(), fma_proof_config()
    else:
        asm, cfg = build_general_lookup()[0].into_assembly(), small_proof_config()
    K.reset_launches()
    s_gpu = generate_setup(asm, cfg, device=dev, stream_threshold_bytes=0)
    p_gpu = prove(asm, s_gpu, cfg, device=dev, stream_threshold_bytes=0)
    assert s_gpu.setup_lde is None and K.LAUNCHES["poseidon2_absorb"] > 0
    p_cpu = prove(asm, generate_setup(asm, cfg, device="cpu"), cfg, device="cpu")
    assert p_gpu.to_json() == p_cpu.to_json()
    assert verify(s_gpu.vk, p_gpu, asm.gates)


def _bb_rand(rng, *shape, device):
    from boojum_tpu_torch.field import babybear as bb

    return bb.from_numpy(rng.integers(0, bb.P, size=shape, dtype=np.uint64), device)


@pytest.mark.parametrize("width", [1, 8, 9, 44])
def test_poseidon2_bb_kernels_match_plain(dev, width):
    """Kernel B8: the permutation (all-zero and all-(p-1) rows included), the
    leaf sponge over plain and paired leaves, and the node compression."""
    from boojum_tpu_torch.field import babybear as bb
    from boojum_tpu_torch.hashes import poseidon2_bb as p2bb

    rng = np.random.default_rng(200 + width)
    states = _bb_rand(rng, 1000, 16, device=dev)
    states[0] = 0
    states[1] = bb.P - 1
    assert torch.equal(p2bb.poseidon2_permutation_bb(states), p2bb.permutation_plain(states))
    cols = _bb_rand(rng, width, 1000, device=dev)
    assert torch.equal(p2bb.leaf_hash_bb(cols), p2bb.leaf_hash_plain(cols))
    assert torch.equal(p2bb.leaf_hash_bb(cols, paired=True),
                       p2bb.leaf_hash_plain(cols, paired=True))
    layer = _bb_rand(rng, 1024, 8, device=dev)
    assert torch.equal(p2bb.node_layer_bb(layer),
                       p2bb.node_hash_plain(layer[0::2], layer[1::2]))


@pytest.mark.parametrize("circuit", ["fma", "xor4", "mini"])
def test_babybear_proof_identical_on_card_and_cpu(dev, circuit):
    from boojum_tpu_torch import kernels as K
    from boojum_tpu_torch.prover import ProofConfig
    from boojum_tpu_torch.prover.bb_prover import BBProofConfig, prove_babybear
    from boojum_tpu_torch.prover.bb_verifier import verify_babybear
    from boojum_tpu_torch.prover.prover_bb import query_paths_hold, quotient_identity_at_z

    K.reset_launches()
    if circuit == "mini":
        p_gpu = prove_babybear(12345, BBProofConfig(log_n=10), device=dev)
        assert p_gpu == prove_babybear(12345, BBProofConfig(log_n=10), device="cpu")
        assert verify_babybear(p_gpu)
    else:
        cs = (build_fma(10, field="babybear") if circuit == "fma"
              else build_xor_lookup(600, 1 << 11, field="babybear")[0])
        asm = cs.into_assembly()
        cfg = ProofConfig(fri_lde_factor=2, num_queries=8, fri_final_degree=8)
        s_gpu = generate_setup(asm, cfg, device=dev)
        p_gpu = prove(asm, s_gpu, cfg, device=dev)
        s_cpu = generate_setup(asm, cfg, device="cpu")
        assert s_gpu.vk.setup_merkle_cap == s_cpu.vk.setup_merkle_cap
        assert p_gpu.to_json() == prove(asm, s_cpu, cfg, device="cpu").to_json()
        assert quotient_identity_at_z(asm, s_gpu, p_gpu)
        assert query_paths_hold(asm, s_gpu, p_gpu)
    assert K.LAUNCHES["poseidon2_bb_leaf"] > 0 and K.LAUNCHES["poseidon2_bb_node"] > 0


@pytest.mark.parametrize("geometry", _GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
@pytest.mark.parametrize("fill", ["random", "p-1", "high"])
def test_hash_gate_programs_kernel_matches_plain(dev, monkeypatch, fill, geometry):
    """B6 over the two flattened permutation gates and the extension FMA
    gate in one launch, each on its own selector path (together a program
    read from global memory), in each launch geometry."""
    monkeypatch.setattr(qs, "launch_geometry", lambda n, parts: geometry)
    geom = circuits.recursion_geometry()
    gates = [Poseidon2FlattenedGate.instance(), PoseidonFlattenedGate.instance(),
             ExtFmaGate.instance()]
    launch = qs.gate_terms_fn(gates, [[0], [1, 0], [1, 1]], geom, dev).launch
    rng = np.random.default_rng(5)
    n = 1 << 11
    r = lambda *shape: _filled(rng, fill, *shape, device=dev)  # noqa: E731
    a = _CHALLENGES[fill][0]
    built = launch(r(130, n), None, r(8, n),
                   [(a + i, a) for i in range(qs.num_gate_terms(gates, geom))])
    assert not qs.prog_in_shared(built[0])
    for got, want in zip(qs.sweep(*built), qs.sweep_plain(*built)):
        _same(got, want)


@pytest.mark.parametrize("transcript", ["poseidon2", "poseidon"])
def test_recursion_proof_card_matches_cpu(dev, transcript):
    """The recursion circuit over the Fibonacci proof (2^10 rows, LDE 2)
    set up and proved on the card and on the CPU: the same cap and proof
    JSON, accepted by the verifier, the inner public input surfaced."""
    cfg = circuits.recursion_inner_config(transcript)
    inner_asm = circuits.fibonacci(circuits.port_recursion_namespace())[0].into_assembly()
    inner_setup = generate_setup(inner_asm, cfg, device=dev)
    inner_proof = prove(inner_asm, inner_setup, cfg, device=dev)
    asm = circuits.build_recursion(inner_setup.vk, [inner_proof],
                                   inner_asm.gates).into_assembly()
    assert asm.trace_len == 1 << 10
    outer_cfg = ProofConfig(fri_lde_factor=2, merkle_tree_cap_size=8, num_queries=4,
                            fri_final_degree=16)
    runs = []
    for device in (dev, "cpu"):
        setup = generate_setup(asm, outer_cfg, device=device)
        runs.append((setup, prove(asm, setup, outer_cfg, device=device)))
    (s_gpu, p_gpu), (s_cpu, p_cpu) = runs
    assert s_gpu.vk.setup_merkle_cap == s_cpu.vk.setup_merkle_cap
    assert p_gpu.to_json() == p_cpu.to_json()
    assert verify(s_gpu.vk, p_gpu, asm.gates)
    assert p_gpu.public_inputs == inner_proof.public_inputs
