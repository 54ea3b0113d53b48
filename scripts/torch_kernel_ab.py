#!/usr/bin/env python3
"""Time the FRI fold (B7) and the NTT kernels (B1-B3) of this checkout
against those of another commit, on one card, in one process, at the shapes
chip_smoke.py's phase 3 gives them.

    python3 scripts/torch_kernel_ab.py OTHER_ROOT [LABEL]

OTHER_ROOT holds the other commit's `boojum_tpu_torch/csrc/` (unpack it with
`git archive <commit> boojum_tpu_torch/csrc | tar -x -C <dir>` into a
git-ignored directory). Its csrc/fri_fold.cu and csrc/ntt.cu are built with
nvcc into a temporary directory and called through the C interfaces they
had before the fold took a whole oracle (`OLD_SIGNATURES`; edit for another
commit): the fold one round a launch (bt_fri_fold), k launches for an
oracle of k rounds, each with its round's table of 1/x; the NTT through its
passes, as now, so its rows are a control (the same code: they must tie).
This checkout's kernels run through the package's wrappers (fri.fold_oracle:
one launch an oracle). The fold rows are each path's first oracle (the
schedule's first entry from the LDE length) and its chain (every entry of
its schedule, each from the last one's result). At each shape the two
outputs must be the same words, then each is timed in turns (other, this,
this, other), each turn the mean of several launches by CUDA events after a
warm-up: through the calls (`other_ms`, `this_ms`, host work included, as
chip_smoke.py times them) and as one CUDA graph of several calls a
version, replayed in the same turns (`other_graph_ms`, `this_graph_ms`:
the device's own time, which host work hides at the small shapes).
Prints the card line and one JSON line {"ab": [...]}.
"""

import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from boojum_tpu_torch import kernels as K  # noqa: E402
from boojum_tpu_torch.field import goldilocks as gf  # noqa: E402
from boojum_tpu_torch.ntt import ntt  # noqa: E402
from boojum_tpu_torch.prover import fri  # noqa: E402

P_, I_, LL_, U64_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint64
IP_ = ctypes.POINTER(ctypes.c_int)
OLD_SIGNATURES = {
    "ntt": {
        "bt_ntt_forward": (P_, P_, P_, I_, P_, P_, IP_, I_, I_, LL_, P_),
        "bt_ntt_inverse": (P_, P_, P_, P_, IP_, I_, I_, LL_, U64_, P_),
    },
    "fri_fold": {
        # c0, c1, outputs, ch0, ch1, 1/x, o0, o1, stream
        "bt_fri_fold": (P_, P_, LL_, U64_, U64_, P_, P_, P_, P_),
    },
}
# (cell, log2 of the LDE length, the trace's log2 and its final degree) of
# phase 3's fold rows: the schedule is fri.fold_schedule's
FOLD_ROWS = [("fma", 22, 20, 16), ("sha256", 19, 16, 16), ("general, witness", 23, 20, 16)]
# (kernel, cell, shape) of phase 3's B1-B3 rows: (rows, log_n[, L])
ROWS = [
    ("ntt_inverse", "fma", (16, 20)), ("ntt_inverse", "sha256", (93, 16)),
    ("ntt_inverse", "general", (9, 20)), ("ntt_inverse", "witness", (12, 20)),
    # the quotient's single rows of Q·n words (prover.py)
    ("ntt_inverse", "fma Q", (1, 22)), ("ntt_inverse", "sha256 Q", (1, 19)),
    ("ntt_inverse", "general, witness Q", (1, 23)),
    ("ntt_inverse", "size", (4, 17)), ("ntt_inverse", "size", (4, 21)),
    ("ntt_inverse", "size", (4, 22)), ("ntt_inverse", "size", (4, 23)),
    ("ntt_forward", "fma", (22, 20, 4)), ("ntt_lde", "witness", (12, 20, 8)),
]


def build_other(root: Path, tmp: Path) -> dict:
    csrc = root / "boojum_tpu_torch" / "csrc"
    procs = {}
    for lib in OLD_SIGNATURES:
        out = tmp / f"{lib}.so"
        procs[lib] = (out, subprocess.Popen(
            [K.nvcc_path(), *K.NVCC_FLAGS, "-I", str(csrc), "-o", str(out),
             str(csrc / f"{lib}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for lib, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the other {lib}.cu:\n{log}")
        handle = ctypes.CDLL(str(out))
        for fn, argtypes in OLD_SIGNATURES[lib].items():
            getattr(handle, fn).argtypes = list(argtypes)
            getattr(handle, fn).restype = ctypes.c_int
        libs[lib] = handle
    return libs


def timed(fn, reps: int) -> float:
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_of(fn, launches: int):
    """A CUDA graph of `launches` calls of fn, captured after a warm-up on a
    side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return g


def replay_ms(g, launches: int) -> float:
    """Milliseconds a launch: the mean of three replays of g."""
    return timed(g.replay, 3) / launches


def fold_cases(libs, dev, rand):
    """The fold rows: the other commit's one-round kernel k times an entry,
    each round with its own table, against fri.fold_oracle with the
    entry's first table."""
    fl = libs["fri_fold"]

    def other_entry(c0, c1, subs, tables):
        for ch, t in zip(subs, tables):
            n_out = c0.shape[0] // 2
            o0 = torch.empty(n_out, dtype=torch.int64, device=dev)
            o1 = torch.empty(n_out, dtype=torch.int64, device=dev)
            K.check(fl.bt_fri_fold(K.ptr(c0), K.ptr(c1), n_out, ch[0], ch[1], K.ptr(t),
                                   K.ptr(o0), K.ptr(o1), K.stream(dev)), "other fri_fold")
            c0, c1 = o0, o1
        return c0, c1

    for cell, log_full, log_n, final in FOLD_ROWS:
        schedule = fri.fold_schedule(1 << log_n, final)
        rounds = fri.fold_challenge_tables(log_full, sum(schedule), dev)
        firsts = fri.fold_entry_tables(log_full, schedule, dev)
        subs = [fri.sub_challenges((3 + e, 5 + e), k) for e, k in enumerate(schedule)]
        tables, r = [], 0
        for k in schedule:
            tables.append(rounds[r:r + k])
            r += k
        c0, c1 = rand(1 << log_full), rand(1 << log_full)
        for label, entries in (("first oracle", 1), ("chain", len(schedule))):

            def run(entry, firsts_or_rounds, entries=entries):
                a, b = c0, c1
                for sub, t in zip(subs[:entries], firsts_or_rounds):
                    a, b = entry(a, b, sub, t)
                return a, b

            ks = ",".join(map(str, schedule[:entries]))
            yield ("fri_fold", cell,
                   f"{label}: 2^{log_full} -> 2^{log_full - sum(schedule[:entries])} "
                   f"(k = {ks})",
                   lambda run=run: run(other_entry, tables),
                   lambda run=run: run(fri.fold_oracle, firsts))


def cases(libs, dev, rand):
    """(kernel, cell, shape text, other call, this call) of each row; each
    call launches on the current stream, so that a graph captures it."""
    yield from fold_cases(libs, dev, rand)
    s = lambda: K.stream(dev)  # noqa: E731
    nl = libs["ntt"]
    for name, cell, shape in ROWS:
        rows, log_n = shape[:2]
        n = 1 << log_n
        x = rand(rows, n)
        if name == "ntt_inverse":
            tabs = ntt._inverse_tables(log_n, str(dev))

            def other(x=x, tabs=tabs, log_n=log_n, rows=rows):
                plan, heap, pre, c_plan, n_inv = tabs
                out = torch.empty_like(x)
                K.check(nl.bt_ntt_inverse(K.ptr(x), K.ptr(out), K.ptr(heap), K.ptr(pre), c_plan,
                                          len(plan), log_n, rows, n_inv, s()),
                        "other ntt inverse")
                return out

            yield (name, cell, f"({rows}, 2^{log_n})", other,
                   lambda x=x: ntt.ifft_bitreversed_to_natural(x))
            continue
        L = shape[2]
        plan, heap, post = ntt._forward_tables(log_n, str(dev))
        if name == "ntt_forward":
            scale = ntt.lde_scale_rows(log_n, L, dev)[1].contiguous()
            text, Lk, rows_out = f"({rows}, 2^{log_n}) x coset row of {L}", 1, rows
            mine = lambda x=x, sc=scale: ntt.fft_natural_to_bitreversed(x, sc)  # noqa: E731
        else:
            scale = ntt.lde_scale_rows(log_n, L, dev)
            text, Lk, rows_out = f"({rows}, 2^{log_n}) -> x{L}", L, rows * L
            mine = lambda x=x, L=L: ntt.lde_from_monomial(x, L)  # noqa: E731

        def other(x=x, scale=scale, Lk=Lk, rows_out=rows_out, log_n=log_n, plan=plan,
                  heap=heap, post=post):
            out = torch.empty((rows_out, 1 << log_n), dtype=torch.int64, device=dev)
            K.check(nl.bt_ntt_forward(K.ptr(x), K.ptr(out), K.ptr(scale), Lk, K.ptr(heap),
                                      K.ptr(post), K.int_array(plan), len(plan), log_n,
                                      rows_out, s()), "other ntt forward")
            return out

        yield name, cell, text, other, lambda m=mine, r=rows_out, n=n: m().reshape(r, n)


def main(other_root: str, label: str) -> None:
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)

    def rand(*shape):
        x = torch.randint(-(2**63), 2**63 - 1, shape, generator=gen, dtype=torch.int64,
                          device=dev)
        return torch.where((x ^ -(2**63)) >= (gf.P ^ 2**63), x - gf.P_I64, x)

    K.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_other(Path(other_root), Path(tmp))
        rows = []
        for name, cell, text, other, mine in cases(libs, dev, rand):
            t0 = time.perf_counter()
            o, m = other(), mine()
            if isinstance(o, tuple):  # the fold's two components, timed unstacked
                o, m = torch.stack(o), torch.stack(m)
            if not torch.equal(o, m):
                raise AssertionError(f"{name} {cell}: the two commits' words differ")
            del o, m
            once = timed(mine, 1)
            reps = max(3, min(50, int(200 / max(once, 0.01))))
            t_o1, t_m1, t_m2, t_o2 = (timed(f, reps) for f in (other, mine, mine, other))
            # 20 launches a graph where host work could hide the device's
            # time, 4 where a launch takes milliseconds
            k = 20 if once < 0.5 else 4
            graphs = {f: graph_of(f, k) for f in (other, mine)}
            g_o1, g_m1, g_m2, g_o2 = (replay_ms(graphs[f], k) for f in (other, mine, mine, other))
            del graphs
            row = {"kernel": name, "cell": cell, "shape": text, "other_ms": [t_o1, t_o2],
                   "this_ms": [t_m1, t_m2], "reps": reps, "other_graph_ms": [g_o1, g_o2],
                   "this_graph_ms": [g_m1, g_m2], "graph_launches": k}
            rows.append(row)
            print(f"  {name:12s} {cell:18s} {text:40s} other {t_o1:.3f} {t_o2:.3f}  this "
                  f"{t_m1:.3f} {t_m2:.3f} ms  graph other {g_o1:.4f} {g_o2:.4f}  this "
                  f"{g_m1:.4f} {g_m2:.4f} ms  [{time.perf_counter() - t0:.1f} s]", flush=True)
            ntt.clear_tables()
            torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"ab": rows, "label": label, "card": card}))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else "")
