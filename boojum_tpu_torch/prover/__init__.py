"""The Goldilocks prover: setup, prove, verify."""

from .config import ProofConfig
from .proof import OracleQuery, Proof, SingleRoundQueries
from .prover import prove
from .setup import SetupData, VerificationKey, generate_setup
from .verifier import verify
