"""Small helpers around the prover: the Fiat-Shamir checkpoint log."""
