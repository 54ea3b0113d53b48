#!/usr/bin/env python3
"""The JAX prover against boojum_tpu_torch on sha256, blake2s or keccak256
over a short message, or on the secp256k1 ladder, on the CPU, the port with
the plain version of every kernel.

    JAX_PLATFORMS=cpu python scripts/torch_sha256_parity.py [--message abc]
    JAX_PLATFORMS=cpu python scripts/torch_sha256_parity.py --bench-bytes 8192
    JAX_PLATFORMS=cpu python scripts/torch_sha256_parity.py --circuit blake2s
    JAX_PLATFORMS=cpu python scripts/torch_sha256_parity.py --circuit secp256k1 --log-n 16
    JAX_PLATFORMS=cpu python scripts/torch_sha256_parity.py --circuit recursion [--transcript poseidon]

Synthesizes bench.py's sha256 circuit (60 copy columns, 8 constant columns,
degree 7, width-4 x8 specialized lookups) in both packages, sets it up and
proves it with bench.py's proof config (LDE 8, cap 16, 50 queries, no PoW,
final degree 16), then prints one JSON line: each side's seconds, the
port's witness resolver (the native tape), whether the checkpoint streams
and the proof JSON texts are equal, and whether each package's verifier
accepts the other's proof. sha256(b"abc") pads to 2^14
rows. `--bench-bytes N` takes bench.py's message of N bytes (byte i is
i mod 255) in place of `--message`: 8192 bytes, bench.py's headline, pad
to 2^16 rows. The port sizes the constraint system's capacity as
bench.py does, and the JAX side takes the port's. `--circuit blake2s` or
`keccak256` proves that hash of the JAX package's tests/test_blake2s.py or
tests/test_keccak.py at the same geometry, lookups and config, by default
of those tests' messages ("hello TPU blake2s": 2^17 rows, the xor8
table's size; "hello TPU keccak": 2^18, the xor8 and and8 tables').
`--circuit secp256k1` proves circuits.secp256k1_ladder, one definition over
each package's classes, with as many ladder steps as fill 2^log_n rows
(`--log-n`, default 16: 49 steps), at the same geometry, lookups and
config. `--circuit recursion` proves circuits.recursion over the JAX tests'
Fibonacci proof (circuits.fibonacci, proved by the port with
`recursion_inner_config` under `--transcript`, poseidon2 or the legacy
poseidon, and carried to the JAX classes by its VK and proof JSON), one
definition over each package's classes: 2^10 rows of the recursion
geometry, proved with tests/test_recursion.py's outer config (LDE 8, cap
8, 4 queries, no PoW, final degree 16). Too slow for the tier-1 tests, so
it is run by hand.
"""

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import conftest  # noqa: E402,F401  (CPU platform, persistent compile cache)

from boojum_tpu.cs.implementations import ConstraintSystem  # noqa: E402
from boojum_tpu.cs.types import CSGeometry, LookupParameters  # noqa: E402
from boojum_tpu.gadgets import allocate_u8_input, sha256  # noqa: E402
from boojum_tpu.gadgets.blake2s import blake2s  # noqa: E402
from boojum_tpu.gadgets.keccak256 import keccak256  # noqa: E402
from boojum_tpu.prover import ProofConfig  # noqa: E402
from boojum_tpu.prover import generate_setup as jgenerate_setup  # noqa: E402
from boojum_tpu.prover import prove as jprove  # noqa: E402
from boojum_tpu.prover import verify as jverify  # noqa: E402
from boojum_tpu.prover.proof import Proof as JProof  # noqa: E402
from boojum_tpu.utils.report import CheckpointLog as JCheckpointLog  # noqa: E402
from boojum_tpu.utils.report import install_checkpoint_log  # noqa: E402
from boojum_tpu.gadgets.boolean import Boolean  # noqa: E402
from boojum_tpu.gadgets.curves import SWProjectivePoint  # noqa: E402
from boojum_tpu.gadgets.non_native_field import SECP256K1_BASE, NonNativeField  # noqa: E402
from boojum_tpu import serialization as jserialization  # noqa: E402
from boojum_tpu.cs.gates import (  # noqa: E402
    BooleanConstraintGate, FmaGate, PublicInputGate, SelectionGate,
)
from boojum_tpu.gadgets.recursion import recursive_verify  # noqa: E402
from boojum_tpu_torch.circuits import (  # noqa: E402
    bench_message, build_blake2s, build_keccak256, build_recursion, build_secp256k1_ladder,
    build_sha256, fibonacci, port_recursion_namespace, recursion, recursion_inner_config,
    secp256k1_ladder, sha256_proof_config,
)
from boojum_tpu_torch.prover import ProofConfig as PortProofConfig  # noqa: E402
from boojum_tpu_torch.serialization import vk_to_json  # noqa: E402

# circuit: (the JAX gadget, the port's build function, the JAX tests' message)
CIRCUITS = {"sha256": (sha256, build_sha256, "abc"),
            "blake2s": (blake2s, build_blake2s, "hello TPU blake2s"),
            "keccak256": (keccak256, build_keccak256, "hello TPU keccak"),
            "secp256k1": (None, None, None), "recursion": (None, None, None)}
# the JAX package's classes the ladder takes (circuits.secp256k1_ladder)
JAX_LADDER = SimpleNamespace(ConstraintSystem=ConstraintSystem, CSGeometry=CSGeometry,
                             LookupParameters=LookupParameters, Boolean=Boolean,
                             NonNativeField=NonNativeField,
                             SWProjectivePoint=SWProjectivePoint,
                             SECP256K1_BASE=SECP256K1_BASE)
# the JAX package's classes circuits.fibonacci and circuits.recursion take
JAX_RECURSION = SimpleNamespace(ConstraintSystem=ConstraintSystem, CSGeometry=CSGeometry,
                                BooleanConstraintGate=BooleanConstraintGate,
                                FmaGate=FmaGate, SelectionGate=SelectionGate,
                                PublicInputGate=PublicInputGate,
                                recursive_verify=recursive_verify)
# tests/test_recursion.py's outer config; bench.py's for the rest
RECURSION_CONFIG = dict(fri_lde_factor=8, merkle_tree_cap_size=8, num_queries=4, pow_bits=0,
                        fri_final_degree=16)
BENCH_CONFIG = dict(fri_lde_factor=8, merkle_tree_cap_size=16, num_queries=50, pow_bits=0,
                    fri_final_degree=16)
from boojum_tpu_torch.prover import generate_setup, prove, verify  # noqa: E402
from boojum_tpu_torch.prover.proof import Proof  # noqa: E402
from boojum_tpu_torch.utils.report import CheckpointLog  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--circuit", choices=sorted(CIRCUITS), default="sha256")
    ap.add_argument("--message", default=None,
                    help="the message, as text (default: the circuit's JAX test's)")
    ap.add_argument("--bench-bytes", type=int, default=None,
                    help="bench.py's message of this many bytes, in place of --message")
    ap.add_argument("--log-n", type=int, default=16,
                    help="secp256k1: the ladder's rows, log2")
    ap.add_argument("--transcript", choices=["poseidon2", "poseidon"], default="poseidon2",
                    help="recursion: the inner proof's transcript")
    args = ap.parse_args()
    jhash, build, default_message = CIRCUITS[args.circuit]
    ladder = args.circuit == "secp256k1"
    rec = args.circuit == "recursion"
    config = RECURSION_CONFIG if rec else BENCH_CONFIG
    if ladder:
        out = {"circuit": args.circuit, "log_n": args.log_n}
    elif rec:
        out = {"circuit": args.circuit, "inner_transcript": args.transcript}
    else:
        message = (bench_message(args.bench_bytes) if args.bench_bytes is not None
                   else (args.message or default_message).encode())
        out = {"circuit": args.circuit, "message_bytes": len(message),
               "bench_message": args.bench_bytes is not None}

    t = time.perf_counter()
    if rec:
        inner_cfg = recursion_inner_config(args.transcript)
        inner = fibonacci(port_recursion_namespace())[0].into_assembly()
        inner_setup = generate_setup(inner, inner_cfg, device="cpu")
        inner_proof = prove(inner, inner_setup, inner_cfg, device="cpu")
        cs = build_recursion(inner_setup.vk, [inner_proof], inner.gates)
    else:
        cs, _output = (build_secp256k1_ladder(args.log_n) if ladder else build(message=message))
    asm = cs.into_assembly()
    out["port_resolver"] = cs.resolver.name
    cfg = PortProofConfig(**config)
    assert rec or cfg == sha256_proof_config()
    setup = generate_setup(asm, cfg, device="cpu")
    log = CheckpointLog()
    proof = prove(asm, setup, cfg, device="cpu", log=log)
    out["rows"] = asm.trace_len
    out["port_cpu_s"] = time.perf_counter() - t
    print(json.dumps({"port_done": out}), flush=True)

    t = time.perf_counter()
    if ladder:
        jcs, _output = secp256k1_ladder(JAX_LADDER, args.log_n)
    elif rec:
        jinner = fibonacci(JAX_RECURSION)[0].into_assembly()
        jcs = recursion(JAX_RECURSION, jserialization.vk_from_json(vk_to_json(inner_setup.vk)),
                        [JProof.from_json(inner_proof.to_json())], jinner.gates)
    else:
        jcs = ConstraintSystem(CSGeometry(60, 0, 8, 7), cs.max_trace_len,
                               lookup_params=LookupParameters(width=4, num_repetitions=8))
        jhash(jcs, allocate_u8_input(jcs, message))
    jasm = jcs.into_assembly()
    jcfg = ProofConfig(**config)
    jsetup = jgenerate_setup(jasm, jcfg)
    jlog = JCheckpointLog()
    prev = install_checkpoint_log(jlog)
    try:
        jproof = jprove(jasm, jsetup, jcfg)
    finally:
        install_checkpoint_log(prev)
    out["jax_cpu_s"] = time.perf_counter() - t

    jstream = [(e["round"], e["label"], e["digest"]) for e in jlog.entries]
    out["streams_equal"] = jstream == log.stream()
    out["proof_json_equal"] = jproof.to_json() == proof.to_json()
    out["proof_bytes"] = len(proof.to_json())
    out["jax_verifier_accepts_port_proof"] = bool(
        jverify(jsetup.vk, JProof.from_json(proof.to_json()), jasm.gates))
    out["port_verifier_accepts_jax_proof"] = bool(
        verify(setup.vk, Proof.from_json(jproof.to_json()), asm.gates))
    print(json.dumps(out))
    ok = all(out[k] for k in ("streams_equal", "proof_json_equal",
                              "jax_verifier_accepts_port_proof",
                              "port_verifier_accepts_jax_proof"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
