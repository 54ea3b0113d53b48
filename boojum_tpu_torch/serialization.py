"""Artifacts: the verification key as JSON and the setup as one `.npz`, as
in the JAX package's serialization.py (era-boojum's serde JSON vk.json and
its memcpy-style setup serialization, fast_serialization.rs). The JSON
text is the JAX package's for the same key. The `.npz` holds every array of
the setup, the Merkle layers included, as numpy words (uint64 over
Goldilocks, uint32 over BabyBear), so a load puts them on the device
without recomputing anything. A proof's JSON is `Proof.to_json` /
`Proof.from_json`."""

from __future__ import annotations

import json

import numpy as np

from . import resolve_device
from .cs.types import CSGeometry, LookupParameters
from .field import babybear as bb
from .field import goldilocks as gf
from .merkle import MerkleTreeWithCap
from .prover.setup import SetupData, VerificationKey
from .transcript import checked_transcript


def vk_to_json(vk: VerificationKey) -> str:
    return json.dumps(vk.to_dict())


def vk_from_json(s: str) -> VerificationKey:
    """The key of `vk_to_json`'s text (or the JAX package's); an unknown
    transcript kind raises ValueError."""
    d = json.loads(s)
    lp = d.get("lookup_params")
    q = d.get("quotient_degree")
    return VerificationKey(
        geometry=CSGeometry(**d["geometry"]),
        trace_len=int(d["trace_len"]),
        fri_lde_factor=int(d["fri_lde_factor"]),
        cap_size=int(d["cap_size"]),
        num_queries=int(d["num_queries"]),
        pow_bits=int(d["pow_bits"]),
        fri_final_degree=int(d["fri_final_degree"]),
        gate_names=list(d["gate_names"]),
        selector_paths=[list(p) for p in d["selector_paths"]],
        public_input_locations=[tuple(x) for x in d["public_input_locations"]],
        setup_merkle_cap=[tuple(int(v) for v in c) for c in d["setup_merkle_cap"]],
        num_copy_cols=int(d["num_copy_cols"]),
        num_wit_cols=int(d["num_wit_cols"]),
        lookup_params=LookupParameters(**lp) if lp else None,
        num_lookup_tables=int(d.get("num_lookup_tables", 0)),
        # a key without one sweeps at its commit rate
        quotient_degree=int(q) if q is not None else int(d["fri_lde_factor"]),
        transcript=checked_transcript(d.get("transcript", "poseidon2")),
        fri_folding_schedule=d.get("fri_folding_schedule"),
    )


def _words(vk):
    """(to numpy, from numpy) of the key's field."""
    if vk.transcript.endswith("babybear"):
        return bb.to_numpy, bb.from_numpy
    return gf.to_numpy, gf.from_numpy


def save_setup(path: str, setup: SetupData):
    """One .npz with every array of the setup and the key as JSON text."""
    to_np, _ = _words(setup.vk)
    arrays = {
        "sigma_cols": np.asarray(setup.sigma_cols),
        "constant_cols": np.asarray(setup.constant_cols),
        "setup_monomials": to_np(setup.setup_monomials),
        "non_residues": np.asarray(setup.non_residues, dtype=np.uint64),
        "vk_json": np.frombuffer(vk_to_json(setup.vk).encode(), dtype=np.uint8),
        "tree_num_layers": np.asarray([len(setup.setup_tree.layers)], dtype=np.int64),
        "tree_cap_size": np.asarray([setup.vk.cap_size], dtype=np.int64),
    }
    if setup.setup_lde is not None:  # a streamed setup keeps no LDE
        arrays["setup_lde"] = to_np(setup.setup_lde)
    for i, layer in enumerate(setup.setup_tree.layers):
        arrays[f"tree_layer_{i}"] = to_np(layer)
    np.savez(path, **arrays)


def load_setup(path: str, device="cuda") -> SetupData:
    """The setup `save_setup` wrote, its tensors on `device`."""
    from .prover.bb_kernels import BBMerkleTree

    device = resolve_device(device)
    with np.load(path) as z:
        vk = vk_from_json(bytes(z["vk_json"]).decode())
        _, from_np = _words(vk)
        layers = [from_np(z[f"tree_layer_{i}"], device)
                  for i in range(int(z["tree_num_layers"][0]))]
        cap_size = int(z["tree_cap_size"][0])
        babybear = vk.transcript.endswith("babybear")
        return SetupData(
            vk=vk,
            sigma_cols=z["sigma_cols"],
            constant_cols=z["constant_cols"],
            setup_monomials=from_np(z["setup_monomials"], device),
            setup_lde=from_np(z["setup_lde"], device) if "setup_lde" in z else None,
            setup_tree=(BBMerkleTree(layers) if babybear
                        else MerkleTreeWithCap(layers, cap_size)),
            selector_paths=vk.selector_paths,
            non_residues=[int(v) for v in z["non_residues"]],
        )
