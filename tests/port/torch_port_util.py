"""Helpers shared by the tests of boojum_tpu_torch against boojum_tpu.

The port's tests live in tests/port/, which pytest collects before the JAX
package's test files: a tier-1 run that its clock cuts inside the JAX
package's long proves has run the port's tests first."""

import ast
from pathlib import Path

import numpy as np
import torch

from boojum_tpu_torch.field import goldilocks as tgf

REPO = Path(__file__).resolve().parents[2]
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


def port_gates(ja):
    """The port's instances of the JAX assembly's gates."""
    from boojum_tpu_torch.compat import port_gate

    return [port_gate(g) for g in ja.gates]


ASSEMBLY_ARRAYS = ("row_gate", "copy_placement", "copy_cols_values", "lookup_placement",
                   "lookup_cols_values", "lookup_table_id_col", "multiplicities")


def assert_same_assembly(ta, ja):
    """The port's assembly `ta` equals the JAX package's `ja` word for word:
    rows, gate order, gate constants, public inputs, placement and values of
    the copy and lookup columns, table ids, multiplicities and, with lookups,
    the stacked tables."""
    assert ta.trace_len == ja.trace_len
    assert [g.name for g in ta.gates] == [g.name for g in ja.gates]
    assert ta.gate_constants == ja.gate_constants
    assert ta.public_inputs == [tuple(p) for p in ja.public_inputs]
    for name in ASSEMBLY_ARRAYS:
        a, b = getattr(ta, name), getattr(ja, name)
        if a is None or b is None:
            assert a is None and b is None, name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    if ta.lookups_enabled:
        assert ta.num_lookup_tables == len(ja.lookup_tables)
        w = ta.lookup_params.width
        np.testing.assert_array_equal(ta.stacked_table_columns(w), ja.stacked_table_columns(w))


def port_geometry(ja):
    import dataclasses

    from boojum_tpu_torch.cs.types import CSGeometry

    return CSGeometry(*dataclasses.astuple(ja.geometry))


def port_lookup_params(ja):
    import dataclasses

    from boojum_tpu_torch.cs.types import LookupParameters

    return (LookupParameters(*dataclasses.astuple(ja.lookup_params))
            if ja.lookups_enabled else None)


def jax_selector_paths(ja):
    """(selector paths, non-residues) of the JAX assembly's setup, without
    the setup's commit (numpy only)."""
    from boojum_tpu.prover.setup import build_selector_tree, non_residues_for_copy_permutation

    _tree, paths = build_selector_tree(ja.gates)
    return paths, non_residues_for_copy_permutation(ja.num_copy_cols_total)


def sweep_against_jax(ja, js, seed, n):
    """One coset of quotient terms of the assembly `ja` (JAX; any lookup
    mode, witness columns too) on n random coset rows: the port's plain
    sweep against prover.py _u64_sweep_core. js: anything with the setup's
    selector_paths and non_residues."""
    import jax
    import jax.numpy as jnp

    from boojum_tpu.field import extension as jext
    from boojum_tpu.prover import prover as jprover
    from boojum_tpu.prover import stages as jstages
    from boojum_tpu_torch.prover import quotient_sweep as qs

    rng = np.random.default_rng(seed)
    lp = ja.lookup_params
    mode, R = ja.lookup_mode, ja.num_lookup_subargs
    lookups = mode != "none"
    w = lp.width if lookups else 0
    Cg, Ct, W = ja.num_copy_cols, ja.num_copy_cols_total, ja.num_wit_cols
    K = ja.geometry.num_constant_columns + (1 if mode == "specialized" else 0)
    M = 1 if lookups else 0
    mk_path = (tuple(js.selector_paths[ja.lookup_marker_gid()]) if mode == "general"
               else None)
    plan = qs.SweepPlan(port_gates(ja), js.selector_paths, port_geometry(ja), Ct, "cpu",
                        port_lookup_params(ja))
    chunks = jstages.chunk_columns(Ct, ja.geometry.max_allowed_constraint_degree)
    lk_ctx = (lookups, mode, R, w, len(chunks) - 1, tuple(tuple(c) for c in chunks),
              plan.num_alpha, Cg, Ct, W, K, M, mk_path)
    core = jprover._u64_sweep_core(ja, js.selector_paths, js.non_residues, lk_ctx)
    rows = (plan.num_wit_rows, plan.num_setup_cols, plan.num_s2_rows, 2)
    assert rows == (Ct + W + M, Ct + K + (w + 1 if lookups else 0),
                    2 * len(chunks) + 2 * (R + 1) * M, 2)
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


def entry_against_jax(entry, ja, seed, n):
    """One standalone entry of the port's sweep (its plain version) against
    the JAX package's stages.py core of the same part, on n random rows at
    the geometry of the JAX assembly `ja`: "gate_terms_fn" (gates and their
    witness loads), "cp_quotient", "lookup_quotient" or
    "lookup_quotient_general"."""
    import jax
    import jax.numpy as jnp

    from boojum_tpu.field import extension as jext
    from boojum_tpu.prover import stages as jstages
    from boojum_tpu_torch.prover import quotient_sweep as qs

    rng = np.random.default_rng(seed)
    u64 = lambda a: jnp.asarray(np.asarray(a, dtype=np.uint64))  # noqa: E731
    scalar = lambda: tuple(int(v) for v in rand_words(rng, 2))  # noqa: E731
    ext_rows = lambda k: rand_words(rng, 2 * k, n)  # noqa: E731
    Cg, Ct, W = ja.num_copy_cols, ja.num_copy_cols_total, ja.num_wit_cols
    deg = ja.geometry.max_allowed_constraint_degree
    if entry == "gate_terms_fn":
        paths, _ks = jax_selector_paths(ja)
        T = jstages.num_gate_sweep_terms(ja)
        copy, wit = rand_words(rng, Cg, n), rand_words(rng, W, n)
        consts = rand_words(rng, ja.geometry.num_constant_columns, n)
        pows = jext.powers_s(scalar(), T)
        fn = jstages._build_gate_sweep(tuple(ja.gates), tuple(tuple(p) for p in paths),
                                       ja.geometry)
        with jax.disable_jit():
            want = fn(u64(copy), u64(wit) if W else None, u64(consts),
                      u64([p[0] for p in pows]), u64([p[1] for p in pows]))
        port = qs.gate_terms_fn(port_gates(ja), paths, port_geometry(ja), "cpu")
        got = port(to_t(copy), to_t(wit) if W else None, to_t(consts), pows)
    elif entry == "cp_quotient":
        _paths, ks = jax_selector_paths(ja)
        chunks = jstages.chunk_columns(Ct, deg)
        s2, zs = ext_rows(len(chunks)), ext_rows(1)
        copy, sigma = rand_words(rng, Ct, n), rand_words(rng, Ct, n)
        xs, l0 = rand_words(rng, n), rand_words(rng, n)
        beta, gamma = scalar(), scalar()
        pows = jext.powers_s(scalar(), 1 + len(chunks))
        with jax.disable_jit():
            want = jstages._cp_quotient_core(
                (u64(s2[0]), u64(s2[1])), (u64(zs[0]), u64(zs[1])),
                [(u64(s2[2 + 2 * j]), u64(s2[3 + 2 * j])) for j in range(len(chunks) - 1)],
                u64(copy), u64(sigma), u64(xs), u64(l0), jstages.ext_scalar(beta),
                jstages.ext_scalar(gamma), u64([p[0] for p in pows]),
                u64([p[1] for p in pows]), tuple(tuple(c) for c in chunks), tuple(ks))
        got = qs.cp_quotient(to_t(s2), to_t(zs), to_t(copy), to_t(sigma), to_t(xs),
                             to_t(l0), beta, gamma, pows, ks, deg)
    else:
        R, w = ja.num_lookup_subargs, ja.lookup_params.width
        ab = ext_rows(R + 1)
        cols = rand_words(rng, R * w, n)
        tid, mult, sel = rand_words(rng, n), rand_words(rng, n), rand_words(rng, n)
        tables = rand_words(rng, w + 1, n)
        lbeta, lgamma = scalar(), scalar()
        pows = jext.powers_s(scalar(), R + 1)
        a_ldes = [(u64(ab[2 * i]), u64(ab[2 * i + 1])) for i in range(R)]
        b_lde = (u64(ab[2 * R]), u64(ab[2 * R + 1]))
        common = (jstages.ext_scalar(lbeta), jstages.ext_scalar(lgamma),
                  u64([p[0] for p in pows]), u64([p[1] for p in pows]), R, w)
        with jax.disable_jit():
            if entry == "lookup_quotient":
                want = jstages._lookup_quotient_core(
                    a_ldes, b_lde, u64(cols), u64(tid), u64(tables), u64(mult), *common)
            else:
                want = jstages._lookup_quotient_core_general(
                    a_ldes, b_lde, u64(cols), u64(tid), u64(tables), u64(mult), u64(sel),
                    *common)
        args = (to_t(ab), to_t(cols), to_t(tid), to_t(tables), to_t(mult))
        if entry == "lookup_quotient":
            got = qs.lookup_quotient(*args, lbeta, lgamma, pows, R, w)
        else:
            got = qs.lookup_quotient_general(*args, to_t(sel), lbeta, lgamma, pows, R, w)
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(wv))
