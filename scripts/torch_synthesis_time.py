#!/usr/bin/env python3
"""Time witness synthesis of boojum_tpu_torch's circuits with the Python
resolver and with the native tape, in turns, and require their assemblies
to be the same word for word.

    python3 scripts/torch_synthesis_time.py [--cells sha256,keccak256,...]
                                            [--other ROOT] [--rounds 1]
                                            [--modes python,native]

The cells (synthesis and `into_assembly`, host seconds):
  sha256         bench.py's headline, sha256 over 8 KiB, 2^16 rows;
  keccak256      keccak256 of the message that fills 2^18 rows;
  secp256k1      the secp256k1 ladder that fills 2^18 rows;
  recursion      the recursion circuit over one sha256 8 KiB proof, 2^15
                 rows (chip_smoke.py's phase 19); the inner proof is made
                 first, on the card when there is one, else on the CPU
                 (minutes);
  fma, general, witness
                 the fma chain, the general-lookup and the witness-column
                 circuits at 2^20 rows (chip_smoke.py's phases 5, 9, 10);
  fma_babybear, xor4_babybear
                 the fma chain and the xor4 lookup circuit over BabyBear at
                 2^20 rows (phases 12, 13), which have no native mode.
The default is the first four. Each round runs, for each cell, python,
native, native, python (BabyBear: python, python), every run in a fresh
process (`python` is `dag.WitnessResolver` passed to every
ConstraintSystem, `native` the default resolver, `make_resolver`);
`--modes native` leaves the Python resolver out over Goldilocks. With
`--other ROOT` (the root of another checkout, e.g. an unpacked
`git archive` of the parent commit) its default synthesis runs first and
last in each round, and its assemblies must be the same words too. Each run
prints its seconds and a digest of its assembly (placement, copy, witness
and lookup columns, multiplicities, public inputs); the script prints one
line per run and at the end one JSON line {"synthesis_time": {...}} with
every run's seconds, the best of each mode and the host's CPU model. Exits
non-zero if two assemblies of one cell differ.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELLS = ("sha256", "keccak256", "secp256k1", "recursion", "fma", "general", "witness",
         "fma_babybear", "xor4_babybear")
DEFAULT_CELLS = CELLS[:4]

# one synthesis in a fresh process: argv root, cell, mode, vk path, proof path
RUN = r"""
import hashlib, json, sys, time
root, cell, mode, vk_path, proof_path = sys.argv[1:6]
sys.path.insert(0, root)
import numpy as np
from boojum_tpu_torch import circuits
if mode != "default":
    from boojum_tpu_torch.dag import WitnessResolver, make_resolver
    from boojum_tpu_torch.field.spec import spec_of
    make = {"python": lambda field: WitnessResolver(p=spec_of(field).p),
            "native": make_resolver}[mode]
    base = circuits.ConstraintSystem
    circuits.ConstraintSystem = lambda *a, **k: base(
        *a, **{**k, "resolver": make(k.get("field", "goldilocks"))})
if cell == "recursion":
    from boojum_tpu_torch.compat import port_gate
    from boojum_tpu_torch.prover.proof import Proof
    from boojum_tpu_torch.serialization import vk_from_json
    vk = vk_from_json(open(vk_path).read())
    proof = Proof.from_json(open(proof_path).read())
    gates = [port_gate(name) for name in vk.gate_names]
t = time.perf_counter()
if cell == "sha256":
    cs = circuits.build_sha256(8192)[0]
elif cell == "keccak256":
    cs = circuits.build_keccak256(18)[0]
elif cell == "secp256k1":
    cs = circuits.build_secp256k1_ladder(18)[0]
elif cell == "recursion":
    cs = circuits.build_recursion(vk, [proof], gates)
elif cell in ("fma", "fma_babybear"):
    cs = circuits.build_fma(20, field="babybear" if cell == "fma_babybear" else "goldilocks")
elif cell == "general":
    cs = circuits.build_general_lookup(20)[0]
elif cell == "witness":
    cs = circuits.build_zero_check_witness(20)[0]
else:
    cs = circuits.build_xor_lookup((1 << 20) - 8, 1 << 20, field="babybear")[0]
asm = cs.into_assembly()
secs = time.perf_counter() - t
h = hashlib.sha256()
for a in (asm.copy_placement, asm.copy_cols_values, asm.wit_cols_values,
          asm.lookup_placement, asm.lookup_cols_values, asm.multiplicities):
    if a is not None:
        h.update(np.ascontiguousarray(a).tobytes())
h.update(repr(asm.public_inputs).encode())
resolver = getattr(getattr(cs, "resolver", None), "name", "eager")
print(json.dumps({"seconds": secs, "rows": asm.trace_len, "resolver": resolver,
                  "digest": h.hexdigest()}))
"""


def log(msg: str) -> None:
    print(msg, flush=True)


def cpu_model() -> str:
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
    except OSError:
        return "unknown"
    for line in out.splitlines():
        if line.startswith("Model name:"):
            return line.split(":", 1)[1].strip()
    return "unknown"


def inner_proof(tmp: str) -> tuple[str, str]:
    """VK and proof JSON files of one sha256 8 KiB proof (sha256's config)."""
    import torch

    sys.path.insert(0, str(ROOT))
    from boojum_tpu_torch.circuits import build_sha256, sha256_proof_config
    from boojum_tpu_torch.prover import generate_setup, prove
    from boojum_tpu_torch.serialization import vk_to_json

    device = "cuda" if torch.cuda.is_available() else "cpu"
    t = time.perf_counter()
    asm = build_sha256(8192)[0].into_assembly()
    setup = generate_setup(asm, sha256_proof_config(), device=device)
    proof = prove(asm, setup, sha256_proof_config(), device=device)
    paths = (os.path.join(tmp, "vk.json"), os.path.join(tmp, "proof.json"))
    for path, text in zip(paths, (vk_to_json(setup.vk), proof.to_json())):
        with open(path, "w") as f:
            f.write(text)
    log(f"inner sha256 proof on {device} ({time.perf_counter() - t:.1f} s)")
    return paths


def run(root: str, cell: str, mode: str, files) -> dict:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", RUN, root, cell, mode, *files],
                       capture_output=True, text=True, env=env, timeout=3000)
    if r.returncode != 0:
        raise RuntimeError(f"{cell} ({mode}, {root}) failed:\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default=",".join(DEFAULT_CELLS))
    ap.add_argument("--other", default=None, help="root of another checkout")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--modes", default="python,native",
                    help="this checkout's resolvers timed over Goldilocks")
    args = ap.parse_args()
    cells = args.cells.split(",")
    unknown = set(cells) - set(CELLS)
    if unknown:
        ap.error(f"unknown cells {sorted(unknown)}")
    gl_modes = args.modes.split(",")
    if not gl_modes or set(gl_modes) - {"python", "native"}:
        ap.error(f"--modes takes python and native, not {args.modes}")
    sys.path.insert(0, str(ROOT))
    from boojum_tpu_torch import native

    native.get_lib()  # built once here, before any timed run loads it
    host = cpu_model()
    log(f"host CPU: {host}")
    with tempfile.TemporaryDirectory() as tmp:
        files = inner_proof(tmp) if "recursion" in cells else ("", "")
        result = {"cpu": host, "other": args.other, "cells": {}}
        failed = False
        for cell in cells:
            modes = (["python", "python"] if cell.endswith("babybear")
                     else [*gl_modes, *reversed(gl_modes)])
            if args.other:
                modes = ["other", *modes, "other"]
            runs = {m: [] for m in dict.fromkeys(modes)}
            digests = set()
            for _ in range(args.rounds):
                for mode in modes:
                    root, m = (args.other, "default") if mode == "other" else (str(ROOT), mode)
                    r = run(root, cell, m, files)
                    runs[mode].append(r["seconds"])
                    digests.add(r["digest"])
                    log(f"{cell} {mode} (resolver {r['resolver']}): {r['seconds']:.2f} s, "
                        f"{r['rows']} rows, assembly {r['digest'][:16]}")
            same = len(digests) == 1
            failed |= not same
            result["cells"][cell] = {"rows": r["rows"], "seconds": runs,
                                     "best": {m: min(v) for m, v in runs.items()},
                                     "assemblies_identical": same}
            log(f"{cell}: best " + ", ".join(f"{m} {min(v):.2f} s" for m, v in runs.items())
                + f"; assemblies {'identical' if same else 'DIFFER'}")
    print(json.dumps({"synthesis_time": result}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
