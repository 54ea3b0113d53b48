#!/usr/bin/env python3
"""Time the quotient-sweep kernel (B6) of one checkout of boojum_tpu_torch on
the card, at the shapes chip_smoke.py's phase 3 gives it: one coset of the
fma 2^20, sha256 2^16, general-lookup 2^20 and witness-column 2^20 proves,
and its four standalone entries (gate_terms_fn, cp_quotient,
lookup_quotient_general, lookup_quotient).

    python3 scripts/torch_sweep_time.py ROOT LABEL [GEOMETRY ...]

ROOT is the directory that holds the `boojum_tpu_torch` package to time
(the repo root, or an unpacked `git archive` of another commit); LABEL names
the run. Each GEOMETRY, comma-separated integers (in this checkout: rows
a thread, threads a block, sub-threads a row, one of those
csrc/quotient_sweep.cu is built for), times that launch geometry as well,
in place of what the checkout's `quotient_sweep.launch_geometry` picks. Each kernel's words are first checked
against the plain version, then each shape gets three means of 20 launches
(CUDA events, ms) after three warm-up launches, on random coset values:
through the wrapper (`ms`, as chip_smoke.py times it, host work included)
and as a CUDA graph of the 20 launches replayed (`graph_ms`, the device's
own time, which the wrapper's host work hides at the small shapes). Prints
one JSON line {"sweep_time": {...}}. Two versions compare only within
one call on one card: run them in turns (a, b, b, a), each in its own
process, since both packages share a name.
"""

import json
import subprocess
import sys

import torch


def main(root: str, label: str, geometries: list) -> None:
    sys.path.insert(0, root)
    from boojum_tpu_torch.circuits import (
        build_fma, build_general_lookup, build_sha256, build_zero_check_witness,
    )
    from boojum_tpu_torch.field import goldilocks as gf
    from boojum_tpu_torch.prover import quotient_sweep as qs
    from boojum_tpu_torch.prover.setup import build_selector_tree

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]

    def rand(*shape):
        x = torch.randint(-(2**63), 2**63 - 1, shape, generator=gen, dtype=torch.int64,
                          device=dev)
        return torch.where((x ^ -(2**63)) >= (gf.P ^ 2**63), x - gf.P_I64, x)

    launches = {}
    asms = {"fma": build_fma(10).into_assembly(),
            "sha256": build_sha256(message=b"abc")[0].into_assembly(),
            "general": build_general_lookup()[0].into_assembly(),
            "witness": build_zero_check_witness()[0].into_assembly()}
    for name, log_n in (("fma", 20), ("sha256", 16), ("general", 20), ("witness", 20)):
        asm, n = asms[name], 1 << log_n
        _tree, paths = build_selector_tree(asm.gates)
        Ct = asm.num_copy_cols_total
        lp = asm.lookup_params if asm.lookups_enabled else None
        plan = qs.SweepPlan(asm.gates, paths, asm.geometry, Ct, dev, lp)
        args = [rand(r, n) for r in (plan.num_wit_rows, plan.num_setup_cols,
                                     plan.num_s2_rows, 2)]
        args += [rand(n) for _ in range(3)]
        table = qs.sweep_table(plan, (3, 5), (7, 11), (13, 17), list(range(1, Ct + 1)),
                               dev, (19, 23), (29, 31))
        launches[name] = (plan, qs.split_oracles(plan, *args), table)
    # the entries at phase 3's shapes
    n, ns = 1 << 20, 1 << 16
    pows = lambda k: [(3 + i, 5 + i) for i in range(k)]  # noqa: E731
    lk = lambda r, wd: ((19, 23), (29, 31), pows(r + 1), r, wd)  # noqa: E731
    wit = asms["witness"]
    _tree, wit_paths = build_selector_tree(wit.gates)
    gate_fn = qs.gate_terms_fn(wit.gates, wit_paths, wit.geometry, dev)
    launches["gate_terms_fn"] = gate_fn.launch(
        rand(8, n), rand(4, n), rand(6, n), pows(qs.num_gate_terms(wit.gates, wit.geometry)))
    launches["cp_quotient"] = qs.cp_quotient_launch(
        rand(4, n), rand(2, n), rand(8, n), rand(8, n), rand(n), rand(n), (3, 5), (7, 11),
        pows(3), list(range(1, 9)), 4)
    launches["lookup_quotient_general"] = qs.lookup_quotient_general_launch(
        rand(6, n), rand(6, n), rand(n), rand(4, n), rand(n), rand(n), *lk(2, 3))
    launches["lookup_quotient"] = qs.lookup_quotient_launch(
        rand(18, ns), rand(32, ns), rand(ns), rand(5, ns), rand(ns), *lk(8, 4))

    picks = getattr(qs, "launch_geometry", None)
    variants = [None] + ([tuple(int(v) for v in g.split(",")) for g in geometries]
                         if picks else [])
    out, graph = {}, {}
    for name, built in launches.items():
        want = qs.sweep_plain(*built)
        for geo in variants:
            if picks:
                qs.launch_geometry = picks if geo is None else (lambda n, parts, g=geo: g)

            def run(built=built):
                return qs.sweep(*built)

            got = run()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{label} {name} {geo}: the kernel's words differ")
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            means = []
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    run()
                end.record()
                torch.cuda.synchronize()
                means.append(start.elapsed_time(end) / 20)
            key = name if geo is None else f"{name} {','.join(map(str, geo))}"
            out[key] = means
            graph[key] = graph_means(run)
            print(f"  {label:8s} {key:34s} " + " ".join(f"{m:.4f}" for m in means)
                  + "  graph " + " ".join(f"{m:.4f}" for m in graph[key]), flush=True)
    print(json.dumps({"sweep_time": {"label": label, "card": card, "ms": out,
                                     "graph_ms": graph}}), flush=True)


def graph_means(run) -> list:
    """Three means of 20 launches captured in one CUDA graph and replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(20):
            run()
    g.replay()
    torch.cuda.synchronize()
    means = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / 20)
    return means


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3:])
