"""One-shot drivers, as in the JAX package's prover/convenience.py
(era-boojum convenience.rs: prove_one_shot, prepare_base_setup_with_
precomputations_and_vk, prove_from_precomputations, verify_circuit). Each
runs on the card unless the caller passes device="cpu"."""

from __future__ import annotations

from .config import ProofConfig
from .prover import prove
from .setup import SetupData, generate_setup
from .verifier import verify


def prove_one_shot(cs, config: ProofConfig | None = None, device="cuda"):
    """A synthesized constraint system -> (assembly, setup, proof)."""
    config = config or ProofConfig()
    assembly, setup = prepare_setup_and_vk(cs, config, device)
    return assembly, setup, prove(assembly, setup, config, device=device)


def prepare_setup_and_vk(cs, config: ProofConfig | None = None, device="cuda"):
    """(assembly, setup) for proving again and again."""
    config = config or ProofConfig()
    assembly = cs.into_assembly()
    return assembly, generate_setup(assembly, config, device=device)


def prove_from_precomputations(assembly, setup: SetupData, config: ProofConfig,
                               device="cuda"):
    """A proof with an existing setup."""
    return prove(assembly, setup, config, device=device)


def verify_circuit(vk, proof, gates) -> bool:
    return verify(vk, proof, gates)
