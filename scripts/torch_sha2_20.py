#!/usr/bin/env python3
"""sha256 over 128 KiB at 2^20 rows, proved by boojum_tpu_torch on one card:
the port's counterpart of scripts/sha2_20_driver.py.

    python3 scripts/torch_sha2_20.py

The circuit is bench.py's sha256 (60 copy, 8 constant columns, degree 7,
width-4 x8 specialized lookups) over a message of 131072 bytes, which fills
2^20 rows; the config is that script's: LDE 2, cap 32, 100 queries, no PoW,
final FRI degree 16. It synthesizes once, then proves by the default stream
rule (at this geometry the setup and the prover both stream their commits)
and with streaming off (threshold math.inf), each with a fresh setup, and
prints, one line per step and one JSON line at the end: synthesis, setup,
cold and warm prove seconds, peak device memory of each rule's setup and
warm prove, whether the two proofs are identical, whether the verifier
accepts, and the circuit's digest against hashlib's. Needs one CUDA card;
exits non-zero without one or if any check fails.
"""

from __future__ import annotations

import hashlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

MESSAGE_BYTES = 131072
LOG_N = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_sha2_20: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from boojum_tpu_torch import kernels as K
    from boojum_tpu_torch.circuits import bench_message, build_sha256
    from boojum_tpu_torch.gadgets import sha256_digest_bytes
    from boojum_tpu_torch.prover import ProofConfig, generate_setup, prove, verify

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    t0 = time.perf_counter()
    K.build_all()
    log(f"kernels built ({time.perf_counter() - t0:.1f} s)")

    t = time.perf_counter()
    message = bench_message(MESSAGE_BYTES)
    cs, digest = build_sha256(MESSAGE_BYTES)
    asm = cs.into_assembly()
    synthesis_s = time.perf_counter() - t
    digest_ok = sha256_digest_bytes(cs, digest) == hashlib.sha256(message).digest()
    resolver = cs.resolver.name
    log(f"synthesis {synthesis_s:.1f} s (resolver {resolver}), {asm.trace_len} rows, "
        f"digest equals hashlib's: {digest_ok}")
    if asm.trace_len != 1 << LOG_N or not digest_ok:
        raise AssertionError("wrong circuit: rows or digest")
    del cs
    cfg = ProofConfig(fri_lde_factor=2, merkle_tree_cap_size=32, num_queries=100,
                      pow_bits=0, fri_final_degree=16)

    result = {"card": card, "message_bytes": MESSAGE_BYTES, "rows": asm.trace_len,
              "synthesis_s": synthesis_s, "resolver": resolver,
              "digest_matches_hashlib": digest_ok}
    proofs = {}
    for rule, kw in (("default", {}), ("materialized", {"stream_threshold_bytes": math.inf})):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t = time.perf_counter()
        setup = generate_setup(asm, cfg, device="cuda", **kw)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t
        setup_peak = torch.cuda.max_memory_allocated() / 2**30
        setup_absorbs = K.LAUNCHES["poseidon2_absorb"]
        walls = []
        for _ in range(2):  # cold, then warm
            torch.cuda.reset_peak_memory_stats()
            K.reset_launches()
            rounds = {}
            t = time.perf_counter()
            proof = prove(asm, setup, cfg, device="cuda", timings=rounds, **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated() / 2**30
        t = time.perf_counter()
        accepted = verify(setup.vk, proof, asm.gates)
        verify_s = time.perf_counter() - t
        proofs[rule] = proof.to_json()
        result[rule] = {
            "setup_streamed": setup.setup_lde is None, "setup_s": setup_s,
            "setup_peak_device_memory_gib": setup_peak, "setup_absorb_launches": setup_absorbs,
            "prove_cold_s": walls[0], "prove_warm_s": walls[1], "rounds_warm_s": rounds,
            "prove_peak_device_memory_gib": peak,
            "prove_absorb_launches": K.LAUNCHES["poseidon2_absorb"],
            "verified": accepted, "verify_s": verify_s,
        }
        log(f"{rule}: setup {setup_s:.1f} s (streamed: {setup.setup_lde is None}, peak "
            f"{setup_peak:.2f} GiB), prove cold {walls[0]:.2f} s, warm {walls[1]:.2f} s, "
            f"peak {peak:.2f} GiB, absorb launches {K.LAUNCHES['poseidon2_absorb']}, "
            f"verified {accepted} ({verify_s:.1f} s)")
        if not accepted:
            raise AssertionError(f"{rule}: proof rejected")
        del setup, proof
    result["proofs_identical"] = proofs["default"] == proofs["materialized"]
    result["proof_bytes"] = len(proofs["default"])
    result["total_s"] = time.perf_counter() - t0
    log(f"proofs identical: {result['proofs_identical']} ({result['proof_bytes']} bytes); "
        f"total {result['total_s']:.1f} s")
    print(json.dumps({"sha2_20": result}))
    if not result["proofs_identical"]:
        raise AssertionError("streamed and materialized proofs differ")
    if not (result["default"]["setup_streamed"] and result["default"]["prove_absorb_launches"]):
        raise AssertionError("the default rule did not stream at this geometry")
    return 0


if __name__ == "__main__":
    sys.exit(main())
