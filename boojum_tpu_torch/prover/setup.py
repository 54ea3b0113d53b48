"""Setup / verification-key generation (era-boojum setup.rs), Goldilocks.

Sigma columns come from a vectorized cycle walk over the copy placement,
constant columns from the degree-aware selector tree; both are built in
numpy on the host, then interpolated, low-degree-extended and
Merkle-committed on the device (kernels B2, B3, B5; past the stream
threshold the commit streams, prover/streaming.py, and B4 absorbs the
blocks, leaving no setup LDE). Setup column order
(prover/layout.py): [sigma over every copy column, the lookup columns
included (C) | constants (K, then the table-id column in specialized mode;
in general mode the table id is the marker row's gate constant) | stacked
table columns (width + 1, lookups only)].

A BabyBear assembly (`assembly.field == "babybear"`) takes the JAX
package's _generate_setup_babybear: int32 columns, the 31^col coset
representatives, the coset-31 LDE and a commit over paired leaves with
kernel B8; its VK names the BabyBear instance of the config's transcript
(poseidon2_babybear or blake2s_babybear).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..cs.selector_tree import GateDescription, compute_selector_placement
from ..field import babybear as bb
from ..field import gl
from ..field import goldilocks as gf
from ..merkle import MerkleTreeWithCap, commit_layers_device
from ..ntt import lde_from_monomial, monomial_from_values
from .layout import OracleLayout
from .streaming import STREAM_THRESHOLD_BYTES, commit_streaming, use_streamed_lde


def build_selector_tree(gates):
    """Degree-aware selector placement; returns (tree, per-gate 0/1 paths)."""
    descriptions = [
        GateDescription(
            gate_idx=i,
            num_constants=g.num_constants,
            degree=g.max_degree,
            is_lookup=g.is_lookup_marker,
        )
        for i, g in enumerate(gates)
    ]
    tree = compute_selector_placement(descriptions)
    paths = []
    for i in range(len(gates)):
        p = tree.output_placement(i)
        if p is None:
            raise RuntimeError(f"gate {i} missing from the selector tree")
        paths.append([int(b) for b in p])
    return tree, paths


def non_residues_for_copy_permutation(num_cols: int) -> list[int]:
    """Coset representatives k_col = g^col (g the multiplicative generator)."""
    out = [1]
    for _ in range(1, num_cols):
        out.append(gl.mul(out[-1], gl.MULTIPLICATIVE_GENERATOR))
    return out


def non_residues_for_copy_permutation_bb(num_cols: int) -> list[int]:
    """BabyBear coset representatives k_col = 31^col (31 generates the
    multiplicative group)."""
    out = [1]
    for _ in range(1, num_cols):
        out.append(bb.mul_s(out[-1], bb.MULTIPLICATIVE_GENERATOR))
    return out


def _sigma_cells(copy_placement: np.ndarray) -> np.ndarray:
    """Flat cell -> next cell in its cycle (cells holding one variable form a
    cycle; vacant cells are fixed points)."""
    pl = copy_placement.reshape(-1)
    N = pl.shape[0]
    order = np.argsort(pl, kind="stable")
    sorted_pl = pl[order]
    pos = np.arange(N)
    same_next = np.zeros(N, dtype=bool)
    same_next[:-1] = sorted_pl[1:] == sorted_pl[:-1]
    first = np.ones(N, dtype=bool)
    first[1:] = sorted_pl[1:] != sorted_pl[:-1]
    group_id = np.cumsum(first) - 1
    starts_per_pos = np.nonzero(first)[0][group_id]
    nxt = np.where(same_next, pos + 1, starts_per_pos)
    sigma_cell = np.empty(N, dtype=np.int64)
    sigma_cell[order] = order[nxt]
    vacant = pl < 0
    sigma_cell[vacant] = np.nonzero(vacant)[0]
    return sigma_cell


def compute_sigma_values(copy_placement: np.ndarray, non_residues=None):
    """(C, n) uint64 of sigma_col(w^row) = k_col' · w^row' for the next cell
    (col', row') of each cell's cycle."""
    C, n = copy_placement.shape
    sigma_cell = _sigma_cells(copy_placement)
    w_pows = gl.powers_np(gl.omega(n.bit_length() - 1), n)
    if non_residues is None:
        non_residues = non_residues_for_copy_permutation(C)
    ks = np.array([int(k) for k in non_residues], dtype=np.uint64)
    vals = gl.mul_np(ks[sigma_cell // n], w_pows[sigma_cell % n])
    return vals.reshape(C, n)


def compute_sigma_values_bb(copy_placement: np.ndarray, non_residues=None):
    """The BabyBear twin of compute_sigma_values: (C, n) uint32."""
    C, n = copy_placement.shape
    sigma_cell = _sigma_cells(copy_placement)
    w_pows = bb.powers_np(bb.omega(n.bit_length() - 1), n)
    if non_residues is None:
        non_residues = non_residues_for_copy_permutation_bb(C)
    ks = np.array([int(k) for k in non_residues], dtype=np.uint32)
    return bb.mul_np(ks[sigma_cell // n], w_pows[sigma_cell % n]).reshape(C, n)


def build_constant_columns(assembly, selector_paths) -> np.ndarray:
    """(K, n) constant columns: on a row of gate g, columns [0, len(path_g))
    hold g's selector path bits and g's own constants follow."""
    n = assembly.trace_len
    K = assembly.geometry.num_constant_columns
    for gid, g in enumerate(assembly.gates):
        if len(selector_paths[gid]) + g.num_constants > K:
            raise ValueError(f"gate {g.name}: selector path + constants exceed {K}")
    cols = np.zeros((K, n), dtype=np.uint64)
    rg = assembly.row_gate
    max_depth = max((len(p) for p in selector_paths), default=0)
    if max_depth:
        bits = np.zeros((len(selector_paths), max_depth), dtype=np.uint64)
        for gid, p in enumerate(selector_paths):
            bits[gid, : len(p)] = p
        cols[:max_depth, :] = bits[rg].T
    offsets = [len(p) for p in selector_paths]
    for row, consts in assembly.gate_constants.items():
        off = offsets[rg[row]]
        for i, c in enumerate(consts):
            cols[off + i, row] = c
    return cols


@dataclass
class VerificationKey:
    """Fixed parameters + setup commitment."""

    geometry: object
    trace_len: int
    fri_lde_factor: int
    cap_size: int
    num_queries: int
    pow_bits: int
    fri_final_degree: int
    gate_names: list
    selector_paths: list
    public_input_locations: list  # [(col, row)]
    setup_merkle_cap: list
    num_copy_cols: int
    num_wit_cols: int
    lookup_params: object
    num_lookup_tables: int
    quotient_degree: int
    transcript: str = "poseidon2"  # the Fiat-Shamir transcript a proof replays
    fri_folding_schedule: list | None = None  # None: fri.fold_schedule's greedy one

    def to_dict(self) -> dict:
        """The JAX package's VK JSON fields, in its order."""
        lp = self.lookup_params
        g = self.geometry
        return {
            "trace_len": self.trace_len,
            "fri_lde_factor": self.fri_lde_factor,
            "quotient_degree": self.quotient_degree,
            "transcript": self.transcript,
            "cap_size": self.cap_size,
            "num_queries": self.num_queries,
            "pow_bits": self.pow_bits,
            "fri_final_degree": self.fri_final_degree,
            "gate_names": list(self.gate_names),
            "selector_paths": [list(p) for p in self.selector_paths],
            "public_input_locations": list(self.public_input_locations),
            "setup_merkle_cap": [list(c) for c in self.setup_merkle_cap],
            "num_copy_cols": self.num_copy_cols,
            "num_wit_cols": self.num_wit_cols,
            "num_lookup_tables": self.num_lookup_tables,
            "fri_folding_schedule": (None if self.fri_folding_schedule is None
                                     else list(self.fri_folding_schedule)),
            "lookup_params": None if lp is None else {
                "width": lp.width,
                "num_repetitions": lp.num_repetitions,
                "share_table_id": lp.share_table_id,
                "use_specialized_columns": lp.use_specialized_columns,
            },
            "geometry": {
                "num_columns_under_copy_permutation": g.num_columns_under_copy_permutation,
                "num_witness_columns": g.num_witness_columns,
                "num_constant_columns": g.num_constant_columns,
                "max_allowed_constraint_degree": g.max_allowed_constraint_degree,
            },
        }


@dataclass
class SetupData:
    """Everything the prover needs beyond the assembly's witness."""

    vk: VerificationKey
    sigma_cols: np.ndarray  # (C, n) host
    constant_cols: np.ndarray  # (K, n) host, the table-id column last
    setup_monomials: torch.Tensor  # (C + K + T, n) device
    # (C + K + T, lde, n) device; None if streamed; BabyBear: (C + K + T, lde·n)
    setup_lde: torch.Tensor | None
    setup_tree: MerkleTreeWithCap  # BabyBear: bb_kernels.BBMerkleTree
    selector_paths: list
    non_residues: list


def quotient_degree_for(assembly, tree, explicit: int | None = None) -> int:
    """The quotient coset count: `explicit` where given (ProofConfig's
    quotient_degree), else the next power of two of the masked constraint
    degree. Either must hold the selector tree's degree and the copy
    permutation's chunks (degree + 1)."""
    tree_degree, tree_constants = tree.compute_stats()
    geom = assembly.geometry
    degree_bound = max(tree_degree, geom.max_allowed_constraint_degree + 1, 1)
    if tree_constants > geom.num_constant_columns:
        raise ValueError("selector tree needs more constant columns")
    q = explicit or 1 << (degree_bound - 1).bit_length()
    if degree_bound > q:
        raise ValueError(f"quotient_degree {q} is below the constraint degree {degree_bound}")
    return q


def commit_setup(assembly, config, sigma, consts, selector_paths,
                 non_residues, quotient_degree, device,
                 stream_threshold_bytes=STREAM_THRESHOLD_BYTES) -> SetupData:
    """Interpolate, extend and commit the setup columns; build the VK.
    In specialized mode `consts` ends with the table-id column; with
    lookups the assembly's stacked tables follow the constants. Past
    `stream_threshold_bytes` of LDE the commit streams and `setup_lde` is
    None."""
    layout = OracleLayout.for_assembly(assembly, selector_paths)
    if sigma.shape[0] != layout.Ct or consts.shape[0] != layout.K:
        raise ValueError(f"setup of {sigma.shape[0]} sigma and {consts.shape[0]} constant "
                         f"columns, the layout has {layout.Ct} and {layout.K}")
    cols = [sigma, consts]
    lookups = layout.lookups
    if lookups:
        cols.append(assembly.stacked_table_columns(layout.width))
    setup_cols = np.concatenate(cols, axis=0)
    monomials = monomial_from_values(gf.from_numpy(setup_cols, device))
    L, cap = config.fri_lde_factor, config.merkle_tree_cap_size
    if use_streamed_lde(setup_cols.shape[0], assembly.trace_len * L,
                        stream_threshold_bytes):
        lde = None
        tree = commit_streaming(monomials, L, cap)
    else:
        lde = lde_from_monomial(monomials, L)
        tree = MerkleTreeWithCap(commit_layers_device(lde, cap), cap)
    vk = VerificationKey(
        geometry=assembly.geometry,
        trace_len=assembly.trace_len,
        fri_lde_factor=config.fri_lde_factor,
        cap_size=config.merkle_tree_cap_size,
        num_queries=config.num_queries,
        pow_bits=config.pow_bits,
        fri_final_degree=config.fri_final_degree,
        gate_names=[g.name for g in assembly.gates],
        selector_paths=selector_paths,
        public_input_locations=[(c, r) for (c, r, _v) in assembly.public_inputs],
        setup_merkle_cap=tree.get_cap(),
        num_copy_cols=sigma.shape[0],
        num_wit_cols=assembly.num_wit_cols,
        lookup_params=assembly.lookup_params if lookups else None,
        num_lookup_tables=assembly.num_lookup_tables,
        quotient_degree=quotient_degree,
        transcript=config.transcript,
        fri_folding_schedule=config.fri_folding_schedule,
    )
    return SetupData(
        vk=vk,
        sigma_cols=sigma,
        constant_cols=consts,
        setup_monomials=monomials,
        setup_lde=lde,
        setup_tree=tree,
        selector_paths=selector_paths,
        non_residues=list(non_residues),
    )


def generate_setup(assembly, config, device="cuda",
                   stream_threshold_bytes=STREAM_THRESHOLD_BYTES) -> SetupData:
    """Sigmas + constants -> monomials -> LDE -> Merkle tree -> VK. The
    commit streams when the setup's LDE would pass `stream_threshold_bytes`
    (prover/streaming.py: 0 always, math.inf never)."""
    device = resolve_device(device)
    if config.fri_final_degree >= assembly.trace_len:
        raise ValueError("fri_final_degree must be below the trace length")
    tree, selector_paths = build_selector_tree(assembly.gates)
    q = quotient_degree_for(assembly, tree, config.quotient_degree)
    if getattr(assembly, "field", "goldilocks") == "babybear":
        return _generate_setup_babybear(assembly, config, selector_paths, q, device)
    sigma = compute_sigma_values(
        np.concatenate([assembly.copy_placement, assembly.lookup_placement], axis=0)
    )
    consts = build_constant_columns(assembly, selector_paths)
    if assembly.lookup_mode == "specialized":
        consts = np.concatenate([consts, assembly.lookup_table_id_col[None, :]], axis=0)
    return commit_setup(
        assembly, config, sigma, consts, selector_paths,
        non_residues_for_copy_permutation(sigma.shape[0]), q, device,
        stream_threshold_bytes,
    )


# a Goldilocks transcript kind -> its BabyBear instance
_BB_TRANSCRIPTS = {"poseidon2": "poseidon2_babybear", "blake2s": "blake2s_babybear"}


def _babybear_transcript(kind: str) -> str:
    """The BabyBear instance of a config's transcript kind."""
    kind = _BB_TRANSCRIPTS.get(kind, kind)
    if not kind.endswith("babybear"):
        raise ValueError(f"transcript {kind} has no BabyBear instance")
    return kind


def _generate_setup_babybear(assembly, config, selector_paths, quotient_degree,
                             device) -> SetupData:
    """The BabyBear setup: uint32 sigma, constant and table columns built on
    the host, then interpolated, extended over the coset 31·<w_N> and
    committed over paired leaves on the device (kernel B8)."""
    from ..ntt import bb_ntt
    from .bb_kernels import BBMerkleTree

    if assembly.lookup_mode == "general":
        raise ValueError("the BabyBear prover supports specialized lookup columns only")
    full_placement = np.concatenate([assembly.copy_placement, assembly.lookup_placement],
                                    axis=0)
    non_residues = non_residues_for_copy_permutation_bb(full_placement.shape[0])
    sigma = compute_sigma_values_bb(full_placement, non_residues)
    consts = build_constant_columns(assembly, selector_paths).astype(np.uint32)
    cols = [sigma, consts]
    if assembly.lookups_enabled:
        consts = np.concatenate(
            [consts, assembly.lookup_table_id_col[None, :].astype(np.uint32)])
        cols = [sigma, consts,
                assembly.stacked_table_columns(assembly.lookup_params.width).astype(np.uint32)]
    monomials = bb_ntt.monomial_from_values(bb.from_numpy(np.concatenate(cols), device))
    L, cap = config.fri_lde_factor, config.merkle_tree_cap_size
    lde = bb_ntt.lde(monomials, L)
    tree = BBMerkleTree.commit(lde, cap)
    vk = VerificationKey(
        geometry=assembly.geometry,
        trace_len=assembly.trace_len,
        fri_lde_factor=L,
        cap_size=cap,
        num_queries=config.num_queries,
        pow_bits=config.pow_bits,
        fri_final_degree=config.fri_final_degree,
        gate_names=[g.name for g in assembly.gates],
        selector_paths=selector_paths,
        public_input_locations=[(c, r) for (c, r, _v) in assembly.public_inputs],
        setup_merkle_cap=tree.get_cap(),
        num_copy_cols=sigma.shape[0],
        num_wit_cols=assembly.num_wit_cols,
        lookup_params=assembly.lookup_params if assembly.lookups_enabled else None,
        num_lookup_tables=assembly.num_lookup_tables,
        quotient_degree=quotient_degree,
        transcript=_babybear_transcript(config.transcript),
        fri_folding_schedule=config.fri_folding_schedule,
    )
    return SetupData(
        vk=vk,
        sigma_cols=sigma,
        constant_cols=consts,
        setup_monomials=monomials,
        setup_lde=lde,
        setup_tree=tree,
        selector_paths=selector_paths,
        non_residues=non_residues,
    )
