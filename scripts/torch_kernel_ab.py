#!/usr/bin/env python3
"""Time the forward NTT (B1, B3) and the Goldilocks Poseidon2 kernels (B4,
B5) of this checkout against those of another commit, on one card, in one
process, at the shapes chip_smoke.py's phase 3 gives them.

    python3 scripts/torch_kernel_ab.py OTHER_ROOT [LABEL]

OTHER_ROOT holds the other commit's `boojum_tpu_torch/csrc/` (unpack it with
`git archive <commit> boojum_tpu_torch/csrc | tar -x -C <dir>` into a
git-ignored directory). Its csrc/ntt.cu and csrc/poseidon2.cu are built with
nvcc into a temporary directory and called through their C interface at the
commit before this redesign (bt_ntt_forward without a pass plan,
bt_poseidon2_set_constants with the diagonal); this checkout's kernels run
through the package's wrappers. At each shape the two outputs must be the
same words, then each is timed in turns (other, this, this, other), each
turn the mean of several launches by CUDA events after a warm-up. Prints the
card line and one JSON line {"ab": [...]}.
"""

import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from boojum_tpu_torch import kernels as K  # noqa: E402
from boojum_tpu_torch.field import goldilocks as gf  # noqa: E402
from boojum_tpu_torch.hashes import poseidon2 as p2  # noqa: E402
from boojum_tpu_torch.hashes import poseidon2_params as params  # noqa: E402
from boojum_tpu_torch.ntt import ntt  # noqa: E402

P_, I_, LL_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
OLD_SIGNATURES = {
    "ntt": {"bt_ntt_forward": (P_, P_, P_, I_, P_, I_, LL_, P_)},
    "poseidon2": {
        "bt_poseidon2_set_constants": (P_, P_),
        "bt_poseidon2_leaf_hash": (P_, I_, LL_, P_, P_),
        "bt_poseidon2_node_hash": (P_, LL_, P_, P_),
        "bt_poseidon2_permute": (P_, LL_, P_, P_),
        "bt_poseidon2_absorb": (P_, P_, I_, LL_, P_),
    },
}
# (kernel, cell, shape) of phase 3's B1, B3, B4 and B5 rows
ROWS = [
    ("ntt_forward", "fma", (22, 20, 4)), ("ntt_forward", "sha256", (106, 16, 8)),
    ("ntt_forward", "general", (18, 20, 8)), ("ntt_forward", "witness", (14, 20, 8)),
    ("ntt_lde", "fma", (16, 20, 4)), ("ntt_lde", "sha256", (93, 16, 8)),
    ("ntt_lde", "general", (9, 20, 8)), ("ntt_lde", "witness", (12, 20, 8)),
    ("poseidon2_permute", "fma", (1 << 22,)), ("poseidon2_permute", "general", (1 << 23,)),
    ("poseidon2_absorb", "fma", (16, 1 << 22)), ("poseidon2_absorb", "general", (16, 1 << 23)),
    ("poseidon2_absorb", "witness", (16, 1 << 23)),
    ("poseidon2_leaf", "fma", (22, 1 << 22)), ("poseidon2_leaf", "sha256", (93, 1 << 19)),
    ("poseidon2_leaf", "general", (18, 1 << 23)), ("poseidon2_leaf", "witness", (14, 1 << 23)),
    ("poseidon2_node", "fma", (1 << 22,)), ("poseidon2_node", "sha256", (1 << 19,)),
    ("poseidon2_node", "general", (1 << 23,)),
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
    rc = np.array(params.ALL_ROUND_CONSTANTS, dtype=np.uint64)
    diag = np.array(params.M_I_DIAGONAL, dtype=np.uint64)
    K.check(libs["poseidon2"].bt_poseidon2_set_constants(rc.ctypes.data_as(P_),
                                                         diag.ctypes.data_as(P_)),
            "other poseidon2 constants")
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


def cases(libs, dev, rand):
    """(kernel, cell, shape text, other call, this call) of each row."""
    s = K.stream(dev)
    nl, pl = libs["ntt"], libs["poseidon2"]
    for name, cell, shape in ROWS:
        if name.startswith("ntt"):
            rows, log_n, L = shape
            ctx = ntt.get_ntt_context(log_n, dev)
            x = rand(rows, 1 << log_n)
            if name == "ntt_forward":
                scale = ntt.lde_scale_rows(log_n, L, dev)[1].contiguous()
                text = f"({rows}, 2^{log_n}) x coset row of {L}"
                Lk, rows_out = 1, rows
                mine = lambda x=x, sc=scale: ntt.fft_natural_to_bitreversed(x, sc)  # noqa: E731
            else:
                scale = ntt.lde_scale_rows(log_n, L, dev)
                text = f"({rows}, 2^{log_n}) -> x{L}"
                Lk, rows_out = L, rows * L
                mine = lambda x=x, L=L: ntt.lde_from_monomial(x, L)  # noqa: E731

            def other(x=x, scale=scale, Lk=Lk, rows_out=rows_out, log_n=log_n, ctx=ctx):
                out = torch.empty((rows_out, 1 << log_n), dtype=torch.int64, device=dev)
                K.check(nl.bt_ntt_forward(K.ptr(x), K.ptr(out), K.ptr(scale), Lk,
                                          K.ptr(ctx.tw), log_n, rows_out, s), "other ntt")
                return out

            yield name, cell, text, other, lambda m=mine, r=rows_out, n=1 << log_n: m().reshape(r, n)
        elif name == "poseidon2_permute":
            (N,) = shape
            st = rand(N, 12)

            def other(st=st):
                out = torch.empty_like(st)
                K.check(pl.bt_poseidon2_permute(K.ptr(st), st.shape[0], K.ptr(out), s), "other")
                return out

            yield name, cell, f"({N}, 12) states", other, lambda st=st: p2.poseidon2_permutation(st)
        elif name == "poseidon2_absorb":
            b, N = shape
            st, cols = rand(N, 12), rand(b, N)
            a_st, b_st = st.clone(), st.clone()

            def other(a_st=a_st, cols=cols, b=b, N=N):
                K.check(pl.bt_poseidon2_absorb(K.ptr(a_st), K.ptr(cols), b, N, s), "other")
                return a_st

            yield (name, cell, f"({b}, {N}) block into ({N}, 12) states", other,
                   lambda b_st=b_st, cols=cols: p2.absorb_cols(b_st, cols))
        elif name == "poseidon2_leaf":
            B, N = shape
            cols = rand(B, N)

            def other(cols=cols, B=B, N=N):
                out = torch.empty((N, 4), dtype=torch.int64, device=dev)
                K.check(pl.bt_poseidon2_leaf_hash(K.ptr(cols), B, N, K.ptr(out), s), "other")
                return out

            yield name, cell, f"({B}, {N}) leaves", other, lambda cols=cols: p2.leaf_hash(cols)
        else:
            (N,) = shape
            layer = rand(N, 4)

            def other(layer=layer, N=N):
                out = torch.empty((N // 2, 4), dtype=torch.int64, device=dev)
                K.check(pl.bt_poseidon2_node_hash(K.ptr(layer), N // 2, K.ptr(out), s), "other")
                return out

            yield name, cell, f"({N}, 4) -> ({N // 2}, 4)", other, lambda layer=layer: p2.node_hash(layer)


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
            # the absorb works in place: compare one launch on equal states
            same = torch.equal(other(), mine())
            if not same:
                raise AssertionError(f"{name} {cell}: the two commits' words differ")
            once = timed(mine, 1)
            reps = max(3, min(50, int(200 / max(once, 0.01))))
            t_o1, t_m1, t_m2, t_o2 = (timed(f, reps) for f in (other, mine, mine, other))
            row = {"kernel": name, "cell": cell, "shape": text, "other_ms": [t_o1, t_o2],
                   "this_ms": [t_m1, t_m2], "reps": reps}
            rows.append(row)
            print(f"  {name:18s} {cell:8s} {text:45s} other {t_o1:.3f} {t_o2:.3f}  this "
                  f"{t_m1:.3f} {t_m2:.3f} ms  [{time.perf_counter() - t0:.1f} s]", flush=True)
            torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"ab": rows, "label": label, "card": card}))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else "")
