#!/usr/bin/env python3
"""keccak256 at 2^20 rows, proved by boojum_tpu_torch on one card: the
Era-sized precompile circuit, run as scripts/torch_sha2_20.py runs sha256.

    python3 scripts/torch_keccak_20.py

The circuit is the JAX package's tests/test_keccak.py keccak256 at bench.py's
sha256 geometry (60 copy, 8 constant columns, degree 7, width-4 x8
specialized lookups: bytes through the 8-bit xor and and tables, rotations
through byte-split tables) over the bench message that fills 2^20 rows
(circuits.keccak256_message_len: 338 blocks of 136 bytes); the config is the
north star's: LDE 2, cap 32, 100 queries, no PoW, final FRI degree 16. It
synthesizes once, then proves by the default stream rule (at this geometry
the setup and the prover both stream their commits) and with streaming off
(threshold math.inf), each with a fresh setup, and profiles a warm prove of
the default rule as chip_smoke.py's phase 6 does. Prints one line per step,
the profile as one JSON line, and at the end one JSON line: synthesis,
setup, cold and warm prove seconds, peak device memory of each rule's setup
and warm prove, whether the two proofs are identical, whether the verifier
accepts, and the circuit's digest against hashes/keccak_host.py. Needs one
CUDA card; exits non-zero without one or if any check fails.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

LOG_N = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_keccak_20: no CUDA device available", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    from boojum_tpu_torch import kernels as K
    from boojum_tpu_torch.circuits import bench_message, build_keccak256, keccak256_message_len
    from boojum_tpu_torch.gadgets import keccak256_digest_bytes
    from boojum_tpu_torch.hashes.keccak_host import keccak256
    from boojum_tpu_torch.prover import ProofConfig, generate_setup, prove, verify
    from chip_smoke import profile_prove

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    t0 = time.perf_counter()
    K.build_all()
    log(f"kernels built ({time.perf_counter() - t0:.1f} s)")

    t = time.perf_counter()
    message = bench_message(keccak256_message_len(LOG_N))
    cs, digest = build_keccak256(LOG_N)
    asm = cs.into_assembly()
    synthesis_s = time.perf_counter() - t
    digest_ok = keccak256_digest_bytes(cs, digest) == keccak256(message)
    resolver = cs.resolver.name
    log(f"synthesis {synthesis_s:.1f} s (resolver {resolver}), {len(message)} bytes, "
        f"{asm.trace_len} rows, digest equals the host's: {digest_ok}")
    if asm.trace_len != 1 << LOG_N or not digest_ok:
        raise AssertionError("wrong circuit: rows or digest")
    del cs
    cfg = ProofConfig(fri_lde_factor=2, merkle_tree_cap_size=32, num_queries=100,
                      pow_bits=0, fri_final_degree=16)

    result = {"card": card, "message_bytes": len(message), "rows": asm.trace_len,
              "synthesis_s": synthesis_s, "resolver": resolver,
              "digest_matches_host": digest_ok}
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
        launches = dict(K.LAUNCHES)
        t = time.perf_counter()
        accepted = verify(setup.vk, proof, asm.gates)
        verify_s = time.perf_counter() - t
        proofs[rule] = proof.to_json()
        result[rule] = {
            "setup_streamed": setup.setup_lde is None, "setup_s": setup_s,
            "setup_peak_device_memory_gib": setup_peak, "setup_absorb_launches": setup_absorbs,
            "prove_cold_s": walls[0], "prove_warm_s": walls[1], "rounds_warm_s": rounds,
            "prove_peak_device_memory_gib": peak, "launches_warm_prove": launches,
            "verified": accepted, "verify_s": verify_s,
        }
        log(f"{rule}: setup {setup_s:.1f} s (streamed: {setup.setup_lde is None}, peak "
            f"{setup_peak:.2f} GiB), prove cold {walls[0]:.2f} s, warm {walls[1]:.2f} s, "
            f"peak {peak:.2f} GiB, launches {launches}, verified {accepted} "
            f"({verify_s:.1f} s)")
        if not accepted:
            raise AssertionError(f"{rule}: proof rejected")
        if rule == "default":
            t = time.perf_counter()
            prof = profile_prove(torch, prove, asm, setup, cfg)
            prof.update(circuit=f"keccak256 2^{LOG_N}", card=card)
            log(f"profile: warm prove {prof['prove_warm_s']:.3f} s, device busy "
                f"{prof['device_busy_ms']:.1f} ms, idle share "
                f"{prof['device_idle_share']:.3f} ({time.perf_counter() - t:.1f} s)")
            print(json.dumps({"profile": prof}))
        del setup, proof
    result["proofs_identical"] = proofs["default"] == proofs["materialized"]
    result["proof_bytes"] = len(proofs["default"])
    result["total_s"] = time.perf_counter() - t0
    log(f"proofs identical: {result['proofs_identical']} ({result['proof_bytes']} bytes); "
        f"total {result['total_s']:.1f} s")
    print(json.dumps({"keccak_20": result}))
    if not result["proofs_identical"]:
        raise AssertionError("streamed and materialized proofs differ")
    if not (result["default"]["setup_streamed"]
            and result["default"]["launches_warm_prove"]["poseidon2_absorb"]):
        raise AssertionError("the default rule did not stream at this geometry")
    return 0


if __name__ == "__main__":
    sys.exit(main())
