#!/usr/bin/env python3
"""Time the quotient-sweep kernel (B6) of one checkout of boojum_tpu_torch on
the card, at the shapes of the fma 2^20 and sha256 2^16 proves.

    python3 scripts/torch_sweep_time.py ROOT LABEL

ROOT is the directory that holds the `boojum_tpu_torch` package to time
(the repo root, or an unpacked `git archive` of another commit); LABEL is
printed first. Prints one line: per shape, three means of 20 launches each
(CUDA events, ms), after three warm-up launches, on random coset values.
Two versions compare only within one call on one card: run them in turns
(a, b, b, a), each in its own process, since both packages share a name.
"""

import sys

import torch


def main(root: str, label: str) -> None:
    sys.path.insert(0, root)
    from boojum_tpu_torch.circuits import build_fma, build_sha256
    from boojum_tpu_torch.field import goldilocks as gf
    from boojum_tpu_torch.prover import quotient_sweep as qs
    from boojum_tpu_torch.prover.setup import build_selector_tree

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    def rand(*shape):
        x = torch.randint(-(2**63), 2**63 - 1, shape, generator=gen, dtype=torch.int64,
                          device=dev)
        return torch.where((x ^ -(2**63)) >= (gf.P ^ 2**63), x - gf.P_I64, x)

    out = []
    for name, asm, n in (("fma", build_fma(10).into_assembly(), 1 << 20),
                         ("sha256", build_sha256(message=b"abc")[0].into_assembly(),
                          1 << 16)):
        _tree, paths = build_selector_tree(asm.gates)
        Ct = asm.num_copy_cols_total
        lp = asm.lookup_params if asm.lookups_enabled else None
        plan = qs.SweepPlan(asm.gates, paths, asm.geometry, Ct, dev, lp)
        args = [rand(r, n) for r in (plan.num_wit_rows, plan.num_setup_cols,
                                     plan.num_s2_rows, 2)]
        args += [rand(n) for _ in range(3)]
        table = qs.sweep_table(plan, (3, 5), (7, 11), (13, 17), list(range(1, Ct + 1)),
                               dev, (19, 23), (29, 31))
        for _ in range(3):
            qs.coset_terms(plan, *args, table)
        torch.cuda.synchronize()
        means = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                qs.coset_terms(plan, *args, table)
            end.record()
            torch.cuda.synchronize()
            means.append(start.elapsed_time(end) / 20)
        out.append(f"{name} " + " ".join(f"{m:.4f}" for m in means))
    print(label, torch.cuda.get_device_name(0), "|", " | ".join(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
