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


def sweep_against_jax(ja, js, seed, n):
    """One coset of quotient terms of the lookup assembly `ja` (JAX) on n
    random coset rows: the port's plain sweep against prover.py
    _u64_sweep_core."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from boojum_tpu.field import extension as jext
    from boojum_tpu.prover import prover as jprover
    from boojum_tpu.prover import stages as jstages
    from boojum_tpu_torch.cs.gates import GATES_BY_NAME
    from boojum_tpu_torch.cs.types import CSGeometry
    from boojum_tpu_torch.prover import quotient_sweep as qs

    rng = np.random.default_rng(seed)
    lp = ja.lookup_params
    R, w = ja.num_lookup_subargs, lp.width
    Cg = ja.geometry.num_columns_under_copy_permutation
    Ct, K = Cg + R * w, ja.geometry.num_constant_columns + 1
    geometry = CSGeometry(*dataclasses.astuple(ja.geometry))
    gates = [GATES_BY_NAME[g.name].instance() for g in ja.gates]
    plan = qs.SweepPlan(gates, js.selector_paths, geometry, Ct, "cpu", lp)
    chunks = jstages.chunk_columns(Ct, ja.geometry.max_allowed_constraint_degree)
    lk_ctx = (True, "specialized", R, w, len(chunks) - 1, tuple(tuple(c) for c in chunks),
              plan.num_alpha, Cg, Ct, 0, K, 1, None)
    core = jprover._u64_sweep_core(ja, js.selector_paths, js.non_residues, lk_ctx)
    rows = (plan.num_wit_rows, plan.num_setup_cols, plan.num_s2_rows, 2)
    assert rows == (Ct + 1, Ct + K + w + 1, 2 * len(chunks) + 2 * (R + 1), 2)
    wit, setup_v, s2, zs = (rand_words(rng, r, n) for r in rows)
    xs, l0, zhinv = (rand_words(rng, n) for _ in range(3))
    alpha, beta, gamma, lbeta, lgamma = (
        tuple(int(v) for v in rand_words(rng, 2)) for _ in range(5))
    pows = jext.powers_s(alpha, plan.num_alpha)
    pair = lambda s: jnp.asarray(np.array(s, dtype=np.uint64))  # noqa: E731
    # op by op: the same function on the same words, without an XLA:CPU
    # compile of the whole core (half a minute at the sha256 geometry)
    with jax.disable_jit():
        want = core(*(jnp.asarray(a) for a in (wit, setup_v, s2, zs, xs, l0, zhinv)),
                    pair([p[0] for p in pows]), pair([p[1] for p in pows]),
                    pair(beta), pair(gamma), pair(lbeta), pair(lgamma))
    table = qs.sweep_table(plan, alpha, beta, gamma, js.non_residues, "cpu", lbeta, lgamma)
    got = qs.coset_terms(plan, *(to_t(a) for a in (wit, setup_v, s2, zs, xs, l0, zhinv)),
                         table)
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(wv))
