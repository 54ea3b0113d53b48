#!/usr/bin/env python3
"""Era's recursion node shape at 2^20 rows, proved by boojum_tpu_torch on
one card: the recursion circuit (circuits.recursion: 130 copy columns, 8
constant columns, degree 7, a flattened Poseidon2 permutation a row)
verifying as many distinct sha256 proofs of one key as fill the rows.

    python3 scripts/torch_recursion_20.py [--log-n 20] [--seed 20]

Each inner proof is bench.py's headline circuit, sha256 over 8 KiB (2^16
rows, LDE 8, cap 16, 50 queries, no PoW, final degree 16), of a message
drawn from the seed, synthesized by a pool of worker processes and proved
on the card with one setup (every message gives the circuit the same
placement, so one key). Each proof is verified into the outer circuit as
it comes; the first one's rows fix how many fill 2^log_n
(circuits.recursion_inner_count). The outer circuit is proved with the
same config (LDE 8 covers its quotient degree 8) with every commit
streamed (threshold 0) and with none (threshold math.inf), each with a
fresh setup; the two proofs must be identical and verify, and the outer
public inputs must be the inner proofs' (sha256 has none). A warm prove of
the streamed rule is profiled as chip_smoke.py's phase 6 does. Prints one line per step,
the profile as one JSON line and at the end one JSON line
{"recursion_20": {...}}. Needs one CUDA card; exits non-zero without one or
if any check fails.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MESSAGE_BYTES = 8192


def log(msg: str) -> None:
    print(msg, flush=True)


def synthesize_sha256(message: bytes):
    """(assembly, digest equals hashlib's, seconds, resolver) of sha256 over
    `message` (run in a worker process, on the CPU)."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    sys.path.insert(0, str(ROOT))
    from boojum_tpu_torch.circuits import build_sha256
    from boojum_tpu_torch.gadgets import sha256_digest_bytes

    t = time.perf_counter()
    cs, digest = build_sha256(message=message)
    ok = sha256_digest_bytes(cs, digest) == hashlib.sha256(message).digest()
    return cs.into_assembly(), ok, time.perf_counter() - t, cs.resolver.name


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=20)
    ap.add_argument("--seed", type=int, default=20)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_recursion_20: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from boojum_tpu_torch import kernels as K
    from boojum_tpu_torch import native
    from boojum_tpu_torch.circuits import (
        port_recursion_namespace, recursion_cs, recursion_inner_count, sha256_proof_config,
        verify_into,
    )
    from boojum_tpu_torch.prover import generate_setup, prove, verify
    from chip_smoke import profile_prove

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    t0 = time.perf_counter()
    native.get_lib()  # the native witness resolver, built once before the workers load it
    # the workers start before this process touches the card
    workers = max(1, (os.cpu_count() or 2) - 2)
    pool = ProcessPoolExecutor(max_workers=workers, mp_context=get_context("spawn"))
    rng = np.random.default_rng(args.seed)
    pending = []

    def submit(count):
        for _ in range(count):
            message = rng.integers(0, 256, MESSAGE_BYTES, dtype=np.uint8).tobytes()
            pending.append(pool.submit(synthesize_sha256, message))

    submit(2 * workers)
    K.build_all()
    log(f"kernels built, {workers} synthesis workers ({time.perf_counter() - t0:.1f} s)")
    cfg = sha256_proof_config()
    ns = port_recursion_namespace()
    outer = recursion_cs(ns, args.log_n)
    inner_setup = first_asm = None
    count = None  # inner proofs that fill 2^log_n, fixed by the first
    stats = {"sha256_synthesis_s": 0.0, "inner_prove_s": 0.0, "outer_synthesis_s": 0.0}
    public_inputs = []
    done = 0
    while count is None or done < count:
        asm, digest_ok, synth_s, inner_resolver = pending.pop(0).result()
        if count is None or done + len(pending) < count:
            submit(1)
        stats["sha256_synthesis_s"] += synth_s
        if not digest_ok:
            raise AssertionError(f"inner circuit {done}: the digest differs from hashlib's")
        if first_asm is None:
            first_asm = asm
            t = time.perf_counter()
            inner_setup = generate_setup(asm, cfg, device="cuda")
            log(f"inner setup {time.perf_counter() - t:.1f} s, {asm.trace_len} rows")
        elif not (np.array_equal(asm.copy_placement, first_asm.copy_placement)
                  and asm.gate_constants == first_asm.gate_constants):
            raise AssertionError(f"inner circuit {done}: its placement differs: not one key")
        t = time.perf_counter()
        proof = prove(asm, inner_setup, cfg, device="cuda")
        torch.cuda.synchronize()
        stats["inner_prove_s"] += time.perf_counter() - t
        if done == 0 and not verify(inner_setup.vk, proof, asm.gates):
            raise AssertionError("the first inner proof is rejected")
        del asm
        rows_before = outer.next_row
        t = time.perf_counter()
        verify_into(ns, outer, inner_setup.vk, proof, first_asm.gates)
        stats["outer_synthesis_s"] += time.perf_counter() - t
        public_inputs += proof.public_inputs
        done += 1
        if count is None:
            rows = outer.next_row - rows_before
            count = recursion_inner_count(args.log_n, rows)
            log(f"one inner proof verified in {rows} rows: {count} fill 2^{args.log_n}")
        if done % 10 == 0 or done == count:
            log(f"{done}/{count} inner proofs proved and verified into the circuit, "
                f"{outer.next_row} rows ({time.perf_counter() - t0:.1f} s)")
    for f in pending:
        f.cancel()
    pool.shutdown()
    t = time.perf_counter()
    outer_asm = outer.into_assembly()
    outer_resolver = outer.resolver.name
    del outer
    stats["outer_synthesis_s"] += time.perf_counter() - t
    if outer_asm.trace_len != 1 << args.log_n:
        raise AssertionError(f"{outer_asm.trace_len} rows, not 2^{args.log_n}")
    result = {"card": card, "log_n": args.log_n, "inner_proofs": count,
              "inner_rows": first_asm.trace_len, "workers": workers,
              "inner_resolver": inner_resolver, "outer_resolver": outer_resolver,
              "gates": sorted({g.name for g in outer_asm.gates}), **stats}
    log(f"recursion circuit: {count} sha256 proofs, {outer_asm.trace_len} rows; sha256 "
        f"synthesis {stats['sha256_synthesis_s']:.1f} s in workers (resolver "
        f"{inner_resolver}), inner proves {stats['inner_prove_s']:.1f} s, outer synthesis "
        f"{stats['outer_synthesis_s']:.1f} s (resolver {outer_resolver})")
    del first_asm, inner_setup

    proofs = {}
    for rule, kw in (("streamed", {"stream_threshold_bytes": 0}),
                     ("materialized", {"stream_threshold_bytes": math.inf})):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t = time.perf_counter()
        setup = generate_setup(outer_asm, cfg, device="cuda", **kw)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t
        setup_peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        rounds = {}
        t = time.perf_counter()
        proof = prove(outer_asm, setup, cfg, device="cuda", timings=rounds, **kw)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = dict(K.LAUNCHES)
        t = time.perf_counter()
        accepted = verify(setup.vk, proof, outer_asm.gates)
        verify_s = time.perf_counter() - t
        proofs[rule] = proof.to_json()
        result[rule] = {
            "setup_streamed": setup.setup_lde is None, "setup_s": setup_s,
            "setup_peak_device_memory_gib": setup_peak, "prove_cold_s": prove_s,
            "rounds_cold_s": rounds, "prove_peak_device_memory_gib": peak,
            "launches_prove": launches, "verified": accepted, "verify_s": verify_s,
            "public_inputs_match": proof.public_inputs == public_inputs,
        }
        log(f"{rule}: setup {setup_s:.1f} s (streamed: {setup.setup_lde is None}, peak "
            f"{setup_peak:.2f} GiB), prove {prove_s:.2f} s, peak {peak:.2f} GiB, launches "
            f"{launches}, verified {accepted} ({verify_s:.1f} s)")
        if not accepted or proof.public_inputs != public_inputs:
            raise AssertionError(f"{rule}: proof rejected or its public inputs differ")
        if rule == "streamed":
            t = time.perf_counter()
            prof = profile_prove(torch, prove, outer_asm, setup, cfg)
            prof.update(circuit=f"recursion over {count} sha256 proofs, 2^{args.log_n}",
                        card=card)
            log(f"profile: warm prove {prof['prove_warm_s']:.3f} s, device busy "
                f"{prof['device_busy_ms']:.1f} ms, idle share "
                f"{prof['device_idle_share']:.3f} ({time.perf_counter() - t:.1f} s)")
            print(json.dumps({"profile": prof}))
        del setup, proof
    result["proofs_identical"] = proofs["streamed"] == proofs["materialized"]
    result["proof_bytes"] = len(proofs["streamed"])
    result["total_s"] = time.perf_counter() - t0
    log(f"proofs identical: {result['proofs_identical']} ({result['proof_bytes']} bytes); "
        f"total {result['total_s']:.1f} s")
    print(json.dumps({"recursion_20": result}))
    if not result["proofs_identical"]:
        raise AssertionError("streamed and materialized proofs differ")
    if not (result["streamed"]["setup_streamed"]
            and result["streamed"]["launches_prove"]["poseidon2_absorb"]):
        raise AssertionError("the streamed rule did not stream")
    return 0


if __name__ == "__main__":
    sys.exit(main())
