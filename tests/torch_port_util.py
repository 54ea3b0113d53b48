"""Helpers shared by the tests of boojum_tpu_torch against boojum_tpu."""

import ast
from pathlib import Path

import numpy as np
import torch

from boojum_tpu_torch.field import goldilocks as tgf

REPO = Path(__file__).resolve().parents[1]
P = 0xFFFFFFFF00000001
BOUNDARY = np.array(
    [0, 1, P - 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63 + 1, P - 2, 7],
    dtype=np.uint64,
)


def rand_words(rng, *shape) -> np.ndarray:
    return rng.integers(0, P, size=shape, dtype=np.uint64)


def to_t(a: np.ndarray) -> torch.Tensor:
    return tgf.from_numpy(a, "cpu")


def to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return tgf.to_numpy(t)
    return np.asarray(t, dtype=np.uint64)


def bench_function(name: str):
    """A top-level function of bench.py, compiled from its source without
    importing bench (whose import configures the JAX compile cache)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    ns: dict = {}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "bench.py", "exec"), ns)
    return ns[name]
