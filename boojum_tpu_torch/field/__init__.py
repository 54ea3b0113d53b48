"""Goldilocks field and its quadratic extension over torch int64 words."""

from . import extension, gl, goldilocks
