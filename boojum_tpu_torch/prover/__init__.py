"""The prover: setup, prove, verify, and the one-shot drivers over them.
`generate_setup` and `prove` take a Goldilocks or a BabyBear assembly
(prover_bb.py); `verify` is Goldilocks only, as in the JAX package."""

from .config import ProofConfig
from .convenience import (
    prepare_setup_and_vk, prove_from_precomputations, prove_one_shot, verify_circuit,
)
from .proof import OracleQuery, Proof, SingleRoundQueries
from .prover import prove
from .setup import SetupData, VerificationKey, generate_setup
from .verifier import verify
