"""The prover: setup, prove, verify. `generate_setup` and `prove` take a
Goldilocks or a BabyBear assembly (prover_bb.py); `verify` is Goldilocks
only, as in the JAX package."""

from .config import ProofConfig
from .proof import OracleQuery, Proof, SingleRoundQueries
from .prover import prove
from .setup import SetupData, VerificationKey, generate_setup
from .verifier import verify
