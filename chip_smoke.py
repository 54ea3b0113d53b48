#!/usr/bin/env python3
"""Smoke test of boojum_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its seconds:
  1. the card's name and power limit, and its 32-bit integer issue rate
     (nvidia-smi, torch.cuda);
  2. the build of every CUDA kernel (one nvcc per source, all at once);
  3. every kernel against its plain PyTorch version on the card, word for
     word (tolerance 0: every result is an exact field element), at the
     shapes the slice's prove gives it, with its time, the plain version's
     time and its bound;
  4. the fma circuit at 2^10 proved on the card and on the CPU: the two
     proofs must be the same JSON text, and the port's verifier must accept;
  5. the slice: the bench fma-chain circuit (16 copy columns, 6 constant
     columns, degree 3; LDE 4, cap 16, 50 queries, no PoW, final degree 16)
     synthesized, set up, proved and verified at 2^20 rows. The launch
     counts go to 0 before synthesis and are read after verification; every
     kernel must have launched on the prove;
  6. where the time of that prove goes: a warm prove (per-round seconds),
     then one under torch.profiler. Device time is grouped into the port's
     CUDA kernels (by kernel), the plain PyTorch work around them (by op)
     and copies; the idle share is 1 - device busy / wall. One JSON line.

Prints the profile line, the kernel table as one JSON line, the card line,
and as the last line
{"ok": true, "device": {...}}. Exits non-zero, with no result, if any phase
fails, if no CUDA device is available, or if the package is missing.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

LOG_N = 20  # the slice: the Era main-VM trace length
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, published
# 32-bit integer multiply-add and add issue per SM per clock on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput); times the SM count and the card's maximum SM clock.
INT32_PER_SM_CLOCK = 64
# 32-bit integer instructions per field op (a 64x64 multiply with its
# reduction; an add, sub or negation with its carry fix-up): an estimate
# from the instruction sequences of csrc/goldilocks.cuh, not a count
OPS_PER_MUL = 16
OPS_PER_ADD = 4

# CUDA kernel function -> the port's kernel it belongs to (phase 6)
PORT_FUNCTIONS = {
    "dif_stage": "ntt_forward/ntt_lde", "dif_tail": "ntt_forward/ntt_lde",
    "dit_head": "ntt_inverse", "dit_stage": "ntt_inverse",
    "leaf_hash": "poseidon2_leaf", "node_hash": "poseidon2_node",
    "sweep": "quotient_sweep", "fold": "fri_fold",
}
# entries the CUDA tracer adds for its own buffers, not work of the prove
PROFILER_MARKERS = ("Command Buffer Full", "Activity Buffer Request")


def log(msg: str) -> None:
    print(msg, flush=True)


class FieldOpCounter:
    """Counts the field multiplies and adds a plain version performs, by
    wrapping the four primitives of field/goldilocks.py."""

    def __init__(self, gf):
        self.gf = gf
        self.muls = 0
        self.adds = 0

    def __enter__(self):
        gf = self.gf
        self.saved = {k: getattr(gf, k) for k in ("mul", "add", "sub", "neg")}

        def wrap(name, field):
            fn = self.saved[name]

            def counted(*args):
                out = fn(*args)
                setattr(self, field, getattr(self, field) + out.numel())
                return out

            return counted

        gf.mul = wrap("mul", "muls")
        for k in ("add", "sub", "neg"):
            setattr(gf, k, wrap(k, "adds"))
        return self

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(self.gf, k, fn)

    @property
    def int_ops(self) -> int:
        return self.muls * OPS_PER_MUL + self.adds * OPS_PER_ADD


def timed(torch, fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(gf, a, b) -> int:
    """Largest |a - b| over the words (as unsigned integers)."""
    na, nb = gf.to_numpy(a).ravel(), gf.to_numpy(b).ravel()
    bad = na != nb
    if not bad.any():
        return 0
    return max(abs(int(x) - int(y)) for x, y in zip(na[bad], nb[bad]))


def nvidia_smi(query: str, fmt: str = "csv,noheader") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def kernel_parity(torch, log_n: int, asm_small, int_ops_per_s: float) -> dict:
    """Every kernel against its plain version at the slice's shapes."""
    from boojum_tpu_torch import kernels as K
    from boojum_tpu_torch.field import goldilocks as gf
    from boojum_tpu_torch.hashes import poseidon2 as p2
    from boojum_tpu_torch.ntt import ntt
    from boojum_tpu_torch.prover import fri, quotient_sweep as qs
    from boojum_tpu_torch.prover.setup import build_selector_tree

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    def rand(*shape):
        x = torch.randint(-(2**63), 2**63 - 1, shape, generator=gen,
                          dtype=torch.int64, device=dev)
        return torch.where((x ^ -(2**63)) >= (gf.P ^ 2**63), x - gf.P_I64, x)

    n = 1 << log_n
    L, Ct, Cs, S, Q = 4, 16, 22, 12, 4
    N = n * L
    w = 8
    _tree, paths = build_selector_tree(asm_small.gates)
    plan = qs.SweepPlan(asm_small.gates, paths, asm_small.geometry, Ct, dev)
    table = qs.sweep_table(plan, (3, 5), (7, 11), (13, 17),
                           [int(v) for v in range(1, Ct + 1)], dev)
    mono_s = rand(Cs, n)
    scale_row = ntt.lde_scale_rows(log_n, Q, dev)[1]
    mono_w = rand(Ct, n)
    leaves = rand(Ct, N)
    layer = rand(N, 4)
    sweep_in = (rand(Ct, n), rand(Cs, n), rand(S, n), rand(2, n), rand(n),
                rand(n), rand(n))
    c0, c1, inv_x = rand(N), rand(N), rand(N // 2)
    cases = {
        # name: (kernel call, plain call, bytes moved, shape)
        "ntt_forward": (
            lambda: ntt.fft_natural_to_bitreversed(mono_s, scale_row),
            lambda: ntt.fft_plain(mono_s, scale_row),
            w * (2 * Cs * n + n + n // 2), f"({Cs}, 2^{log_n}) x coset row",
        ),
        "ntt_inverse": (
            lambda: ntt.ifft_bitreversed_to_natural(mono_w),
            lambda: ntt.ifft_plain(mono_w),
            w * (2 * Ct * n + n // 2), f"({Ct}, 2^{log_n})",
        ),
        "ntt_lde": (
            lambda: ntt.lde_from_monomial(mono_w, L),
            lambda: ntt.lde_plain(mono_w, ntt.lde_scale_rows(log_n, L, dev)),
            w * (Ct * n + L * n + n // 2 + Ct * L * n), f"({Ct}, 2^{log_n}) -> x{L}",
        ),
        "poseidon2_leaf": (
            lambda: p2.leaf_hash(leaves),
            lambda: p2.leaf_hash_plain(leaves),
            w * (Ct * N + 4 * N), f"({Ct}, 2^{log_n + 2}) leaves",
        ),
        "poseidon2_node": (
            lambda: p2.node_hash(layer),
            lambda: p2.node_hash_plain(layer),
            w * (4 * N + 2 * N), f"(2^{log_n + 2}, 4) -> (2^{log_n + 1}, 4)",
        ),
        "quotient_sweep": (
            lambda: torch.stack(qs.coset_terms(plan, *sweep_in, table)),
            lambda: torch.stack(qs.coset_terms_plain(plan, *sweep_in, table)),
            w * ((Ct + Cs + S + 2 + 3) * n + table.numel() + 2 * n),
            f"one coset of 2^{log_n} rows",
        ),
        "fri_fold": (
            lambda: torch.stack(fri.fold_once(c0, c1, (3, 5), inv_x)),
            lambda: torch.stack(fri.fold_once_plain(c0, c1, (3, 5), inv_x)),
            w * (2 * N + N // 2 + N), f"2^{log_n + 2} -> 2^{log_n + 1}",
        ),
    }
    rows = {}
    for name, (kern, plain, nbytes, shape) in cases.items():
        t0 = time.perf_counter()
        got = kern()
        with FieldOpCounter(gf) as ops:
            want = plain()
        torch.cuda.synchronize()
        err = max_abs_err(gf, got, want)
        ms = timed(torch, kern, 5)
        plain_ms = timed(torch, plain, 1)
        bound_bytes = nbytes / MEM_BYTES_PER_S * 1e3
        bound_ops = ops.int_ops / int_ops_per_s * 1e3
        lib, replaces = K.KERNELS[name]
        rows[name] = {
            "name": name,
            "route": "cuda",
            "source": f"boojum_tpu_torch/csrc/{lib}.cu",
            "replaces": replaces,
            "shape": shape,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": None,
        }
        log(f"  {name:15s} {shape:32s} err={err} kernel {ms:.3f} ms  plain "
            f"{plain_ms:.1f} ms  bound {rows[name]['bound_ms']:.3f} ms "
            f"({rows[name]['bound_by']})  [{time.perf_counter() - t0:.1f} s]")
        if err:
            raise AssertionError(f"kernel {name} disagrees with its plain version")
    return rows


def _device_us(evt) -> float:
    """Device microseconds of a profiler entry's own work."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_prove(torch, prove, asm, setup, cfg) -> dict:
    """Phase 6: a warm prove, then one under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    warm = {}
    t = time.perf_counter()
    prove(asm, setup, cfg, device="cuda", timings=warm)
    warm_s = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        prove(asm, setup, cfg, device="cuda")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    kernels, plain, copies = {}, {}, 0.0
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us <= 0 or evt.key.startswith(("aten::", "cuda") + PROFILER_MARKERS):
            continue
        if evt.key.startswith(("Memcpy", "Memset")):
            copies += us / 1e3
            continue
        port = next((v for k, v in PORT_FUNCTIONS.items() if k in evt.key), None)
        bucket, name = (kernels, port) if port else (plain, evt.key[:80])
        bucket[name] = bucket.get(name, 0.0) + us / 1e3
    busy_ms = sum(kernels.values()) + sum(plain.values()) + copies
    return {
        "prove_warm_s": warm_s,
        "rounds_warm_s": warm,
        "profiled_prove_wall_s": wall_s,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / (wall_s * 1e3),
        "port_kernels_ms": dict(sorted(kernels.items(), key=lambda kv: -kv[1])),
        "plain_torch_ms": sum(plain.values()),
        "plain_torch_top_ms": dict(sorted(plain.items(), key=lambda kv: -kv[1])[:12]),
        "copies_ms": copies,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import boojum_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: boojum_tpu_torch not importable: {e}", file=sys.stderr)
        return 2
    from boojum_tpu_torch import kernels as K
    from boojum_tpu_torch.circuits import build_fma, fma_proof_config
    from boojum_tpu_torch.prover import generate_setup, prove, verify

    t0 = time.perf_counter()
    card = nvidia_smi("name,power.limit")
    max_sm_mhz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_ops_per_s = sms * INT32_PER_SM_CLOCK * max_sm_mhz * 1e6
    log(f"[1] card: {card}; {sms} SMs at up to {max_sm_mhz:.0f} MHz: "
        f"{int_ops_per_s / 1e12:.2f}e12 32-bit integer ops/s "
        f"({time.perf_counter() - t0:.1f} s)")

    t = time.perf_counter()
    built = K.build_all()
    log(f"[2] built {', '.join(p.name for p in built.values())} "
        f"({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    asm10 = build_fma(10).into_assembly()
    log(f"[3] kernels against their plain versions at the 2^{LOG_N} slice's shapes")
    rows = kernel_parity(torch, LOG_N, asm10, int_ops_per_s)
    log(f"[3] all {len(rows)} kernels word-exact ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    cfg = fma_proof_config()
    s_gpu = generate_setup(asm10, cfg, device="cuda")
    p_gpu = prove(asm10, s_gpu, cfg, device="cuda")
    s_cpu = generate_setup(asm10, cfg, device="cpu")
    p_cpu = prove(asm10, s_cpu, cfg, device="cpu")
    if p_gpu.to_json() != p_cpu.to_json():
        raise AssertionError("2^10 proofs differ between the card and the CPU")
    if not verify(s_gpu.vk, p_gpu, asm10.gates):
        raise AssertionError("2^10 proof rejected")
    log(f"[4] fma 2^10: card and CPU proofs identical "
        f"({len(p_gpu.to_json())} bytes), verified ({time.perf_counter() - t:.1f} s)")

    # the main path: every count goes to 0 here and is read after verify
    K.reset_launches()
    t = time.perf_counter()
    asm = build_fma(LOG_N).into_assembly()
    log(f"[5] fma 2^{LOG_N}: synthesis {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    setup = generate_setup(asm, cfg, device="cuda")
    torch.cuda.synchronize()
    at_setup = dict(K.LAUNCHES)
    log(f"[5] setup {time.perf_counter() - t:.1f} s; launches {at_setup}")
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    t = time.perf_counter()
    proof = prove(asm, setup, cfg, device="cuda", timings=timings)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t
    on_prove = {k: v - at_setup[k] for k, v in K.LAUNCHES.items()}
    log(f"[5] prove {prove_s:.2f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; rounds "
        + ", ".join(f"{k} {v:.2f} s" for k, v in timings.items())
        + f"; launches {on_prove}")
    t = time.perf_counter()
    if not verify(setup.vk, proof, asm.gates):
        raise AssertionError(f"2^{LOG_N} proof rejected by the verifier")
    if len(proof.queries) != cfg.num_queries or not proof.fri_caps:
        raise AssertionError("proof has the wrong shape")
    launches = dict(K.LAUNCHES)
    log(f"[5] verified ({time.perf_counter() - t:.1f} s); launches on the main "
        f"path {launches}")
    missing = [k for k in rows if launches[k] == 0 or on_prove[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the prove: {missing}")
    for name, row in rows.items():
        row["launches"] = launches[name]

    t = time.perf_counter()
    prof = profile_prove(torch, prove, asm, setup, cfg)
    prof.update(card=card, prove_cold_s=prove_s, rounds_cold_s=timings,
                peak_device_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[6] warm prove {prof['prove_warm_s']:.3f} s, device busy "
        f"{prof['device_busy_ms']:.1f} ms, idle share "
        f"{prof['device_idle_share']:.3f} ({time.perf_counter() - t:.1f} s)")
    print(json.dumps({"profile": prof}))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
