"""Poseidon2 over Goldilocks: kernel wrappers, plain versions, host mirror."""
