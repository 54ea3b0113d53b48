"""Goldilocks and its quadratic extension over torch int64 words; BabyBear
and its quartic extension over int32 words; the fields' protocol records."""

from . import babybear, extension, gl, goldilocks, spec
