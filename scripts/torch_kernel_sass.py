#!/usr/bin/env python3
"""What nvcc makes of the Goldilocks kernels of boojum_tpu_torch, on a machine
with the CUDA toolkit (no card needed).

    python3 scripts/torch_kernel_sass.py [ROOT]

ROOT holds the `boojum_tpu_torch` package (default: this checkout). Prints
1. `nvcc -Xptxas -v` for csrc/ntt.cu, csrc/poseidon2.cu,
   csrc/quotient_sweep.cu and csrc/fri_fold.cu: each kernel's registers,
   stack frame, shared memory and spills;
2. one JSON line {"sass_kernels": ...}: for each kernel of
   csrc/quotient_sweep.cu, each inverse NTT pass of csrc/ntt.cu and each
   fold of csrc/fri_fold.cu (one a number of rounds K: a thread's whole
   work for one output), its SASS instructions by class (the pipes below,
   and the local, shared and global loads and stores), so a stack-resident
   array shows as LDL/STL;
3. one JSON line {"sass_per_op": ...}: the SASS instructions of each field
   primitive of csrc/goldilocks.cuh, by pipe. Each primitive is chained 8
   times in a micro-kernel, and the same kernel with no call (same loads
   and store) is subtracted,
   so a count is per call. Pipes: "fma" is the IMAD family (integer
   multiply-adds, including the compiler's IMAD.MOV and IMAD.IADD), "alu"
   the integer adds, logic, shifts, compares, selects and moves, "other"
   the rest (none expected).

chip_smoke.py's per-pipe bound prices the plain versions' field operations
with these counts.
"""

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
CHAIN = 8
# primitive -> (setup, one call updating the chained value, what consumes it)
OPS = {
    "mul": ("", "a = gl::mul(a, b);", ""),
    "mul_lazy": ("", "a = gl::mul_lazy(a, b);", ""),
    "add": ("", "a = gl::add(a, b);", ""),
    "sub": ("", "a = gl::sub(a, b);", ""),
    "add_lazy": ("", "a = gl::add_lazy(a, b);", ""),
    "sub_lazy": ("", "a = gl::sub_lazy(a, b);", ""),
    # the lazy GF(p^2) product, per call (its c1 folded into the chain)
    "ext_mul_lazy": ("", "{ const gl::Ext e = gl::ext_mul_lazy({a, b}, {b, a}); "
                         "a = e.c0 ^ e.c1; }", ""),
    # a 128-bit product into an accumulator, a word into one, its reduction
    "acc_mac": ("gl::Acc acc = gl::prod(a, b);", "acc = gl::acc_mac(acc, acc.lo, b);",
                "a = acc.lo ^ acc.hi ^ acc.k;"),
    "acc_add": ("gl::Acc acc = gl::prod(a, b);", "acc = gl::acc_add(acc, acc.hi, 0);",
                "a = acc.lo ^ acc.hi ^ acc.k;"),
    "reduce_acc_lazy": ("", "a = gl::reduce_acc_lazy({a, b, 3u});", ""),
    # one pair of csrc/fri_fold.cu's fold, as the kernel writes it: the
    # first round's (canonical words: the carry-chain subtract) and a later
    # round's (lazy words); both components chained, 1/x and the challenge
    # words fixed
    **{f"fold_pair_{name}": (
        "uint64_t a1 = b ^ 0x5555; const uint64_t c = b + 0x777;",
        f"{{ const uint64_t d0 = gl::{sub}(a, b), d1 = gl::{sub}(a1, c); "
        "const uint64_t g0 = gl::reduce_acc_lazy(gl::acc_mac(gl::prod(d0, c), d1, b)); "
        "const uint64_t g1 = gl::reduce_acc_lazy(gl::acc_mac(gl::prod(d0, b), d1, c)); "
        "a = gl::reduce_acc_lazy(gl::acc_add(gl::acc_add(gl::prod(c, g0), a, 0), b, 0)); "
        "a1 = gl::reduce_acc_lazy(gl::acc_add(gl::acc_add(gl::prod(c, g1), a1, 0), c, 0)); }",
        "a ^= a1;") for name, sub in (("first", "sub"), ("lazy", "sub_lazy"))},
    # one word of the internal layer: a * 2^9 plus the state's sum, reduced
    "shift_add_reduce_lazy": (
        "const gl::W tot = {uint32_t(b), uint32_t(b >> 32), 11u};",
        "a = gl::reduce_w_lazy(gl::wadd(gl::wshl<9>(a), tot));", ""),
    "wadd": ("gl::W w = gl::wide(a); const gl::W v = {uint32_t(b), uint32_t(b >> 32), 3u};",
             "w = gl::wadd(w, v);",
             "a = (uint64_t(w.w1) << 32 | w.w0) ^ w.w2;"),
    "reduce_w_lazy": ("", "a = gl::reduce_w_lazy({uint32_t(a), uint32_t(a >> 32), uint32_t(b)});",
                      ""),
    "reduce_w": ("", "a = gl::reduce_w({uint32_t(a), uint32_t(a >> 32), uint32_t(b)});", ""),
}
FMA = ("IMAD",)
ALU = ("IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "PRMT", "IMNMX", "FSEL", "PLOP3",
       "IABS", "VIADD", "MOV", "ICMP", "P2R", "R2P", "FLO", "POPC", "BMSK", "SGXT")
CUDA_BIN = Path("/usr/local/cuda/bin")
MEMORY = ("LDL", "STL", "LDS", "STS", "LDG", "STG", "LDC", "ULDC")


def tool(name: str) -> str:
    return str(CUDA_BIN / name) if (CUDA_BIN / name).exists() else name


def micro_source(ops: dict) -> str:
    out = ['#include "goldilocks.cuh"']
    for name, (setup, call, tail) in ops.items():
        for n in (0, CHAIN):
            body = "\n    ".join([call] * n)
            out.append(f"""extern "C" __global__ void k_{name}_{n}(uint64_t* x, const uint64_t* y) {{
    const int i = threadIdx.x;
    uint64_t a = x[i];
    const uint64_t b = y[i];
    {setup}
    {body}
    {tail}
    x[i] = a ^ b;
}}""")
    return "\n".join(out)


def sass_functions(cubin: Path) -> dict[str, list[str]]:
    text = subprocess.run([tool("cuobjdump"), "-sass", str(cubin)], capture_output=True, text=True,
                          check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and cur is not None:
            cur.append(m.group(1))
    return funcs


def pipe_counts(opcodes: list[str], memory: bool = False) -> dict[str, int]:
    c = {"fma": 0, "alu": 0, "other": 0}
    if memory:
        c.update({m.lower(): 0 for m in MEMORY})
    for op in opcodes:
        base = op.split(".")[0]
        if memory and base in MEMORY:
            c[base.lower()] += 1
        elif base in FMA:
            c["fma"] += 1
        elif base in ALU:
            c["alu"] += 1
        else:
            c["other"] += 1
    return c


def main(root: Path) -> None:
    csrc = root / "boojum_tpu_torch" / "csrc"
    nvcc = tool("nvcc")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for lib in ("ntt", "poseidon2", "quotient_sweep", "fri_fold"):
            r = subprocess.run([nvcc, *FLAGS, "-cubin", "-Xptxas", "-v", "-I", str(csrc), "-o",
                                str(tmp / f"{lib}.cubin"), str(csrc / f"{lib}.cu")],
                               capture_output=True, text=True)
            print(f"== nvcc -Xptxas -v csrc/{lib}.cu (rc {r.returncode})")
            for line in (r.stdout + r.stderr).splitlines():
                if "Compiling entry" in line or "Used" in line or "spill" in line \
                        or "stack frame" in line or "error" in line:
                    print("  " + line.strip())
        kernels = {}
        for lib, pattern in (("quotient_sweep", "sweep"), ("ntt", "dit"),
                             ("fri_fold", "fold_oracle")):
            for name, opcodes in sass_functions(tmp / f"{lib}.cubin").items():
                if pattern in name:
                    kernels[name] = {"total": len(opcodes), **pipe_counts(opcodes, memory=True)}
        print(json.dumps({"sass_kernels": kernels}))
        # the primitives this checkout's goldilocks.cuh has
        header = (csrc / "goldilocks.cuh").read_text()
        ops = {k: v for k, v in OPS.items()
               if all(f" {f}(" in header for f in re.findall(r"gl::(\w+)\(", "".join(v)))}
        src = tmp / "micro.cu"
        src.write_text(micro_source(ops))
        subprocess.run([nvcc, *FLAGS, "-cubin", "-I", str(csrc), "-o", str(tmp / "micro.cubin"),
                        str(src)], check=True)
        funcs = sass_functions(tmp / "micro.cubin")
    per_op = {}
    for name in ops:
        full, base = pipe_counts(funcs[f"k_{name}_{CHAIN}"]), pipe_counts(funcs[f"k_{name}_0"])
        per_op[name] = {k: (full[k] - base[k]) / CHAIN for k in full}
    print(json.dumps({"sass_per_op": per_op}))


if __name__ == "__main__":
    main(Path(sys.argv[1]) if len(sys.argv) > 1 else Path(__file__).resolve().parent.parent)
