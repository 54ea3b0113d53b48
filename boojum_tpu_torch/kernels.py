"""Build, load and count the port's CUDA kernels.

Each source under `csrc/` is compiled by nvcc for sm_90a into a shared
library with a plain C interface and loaded with ctypes. The build happens at
first use, never at import, into `_build/` beside this file (git-ignored),
under a file name that hashes the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. `build_all()` starts one
nvcc per source at once.

Every kernel wrapper adds one to `LAUNCHES[name]` where it launches its
kernel, and nowhere else; `reset_launches()` sets every count to 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# kernel -> (library, TPU kernel it replaces)
KERNELS = {
    "ntt_forward": ("ntt", "boojum_tpu/ntt/mxu_ntt.py:359 _fwd_kernel"),
    "ntt_inverse": ("ntt", "boojum_tpu/ntt/mxu_ntt.py:378 _inv_kernel"),
    "ntt_lde": ("ntt", "boojum_tpu/ntt/mxu_ntt.py:371 _fwd_scaled_kernel"),
    "poseidon2_leaf": (
        "poseidon2", "boojum_tpu/hashes/pallas_poseidon2.py:157 _sponge_kernel"
    ),
    "poseidon2_node": (
        "poseidon2", "boojum_tpu/hashes/pallas_poseidon2.py:157 _sponge_kernel"
    ),
    "poseidon2_permute": (
        "poseidon2", "boojum_tpu/hashes/pallas_poseidon2.py:151 _perm_kernel"
    ),
    "poseidon2_absorb": (
        "poseidon2", "boojum_tpu/hashes/pallas_poseidon2.py:151 _perm_kernel"
    ),
    "quotient_sweep": (
        "quotient_sweep",
        "boojum_tpu/prover/pallas_sweep.py:537 build_coset_terms",
    ),
    "fri_fold": (
        "fri_fold",
        "boojum_tpu/prover/pallas_sweep.py:858 _fold_body, k rounds as "
        "boojum_tpu/prover/fri.py:199 _fri_fold_fn",
    ),
    "poseidon2_bb_permute": (
        "poseidon2_bb", "boojum_tpu/hashes/poseidon2_bb.py:208 _perm_kernel"
    ),
    "poseidon2_bb_leaf": (
        "poseidon2_bb", "boojum_tpu/hashes/poseidon2_bb.py:208 _perm_kernel"
    ),
    "poseidon2_bb_node": (
        "poseidon2_bb", "boojum_tpu/hashes/poseidon2_bb.py:208 _perm_kernel"
    ),
}
# the quotient sweep's standalone entries (prover/quotient_sweep.py): the
# same launch with parts switched off, counted as the sweep's launches ->
# the TPU entry each replaces
SWEEP_ENTRIES = {
    "cp_quotient": "boojum_tpu/prover/pallas_sweep.py:680 cp_quotient",
    "lookup_quotient": "boojum_tpu/prover/pallas_sweep.py:764 lookup_quotient",
    "lookup_quotient_general":
        "boojum_tpu/prover/pallas_sweep.py:776 lookup_quotient_general",
    "gate_terms_fn": "boojum_tpu/prover/pallas_sweep.py:788 gate_terms_fn",
}
LIBRARIES = ("ntt", "poseidon2", "quotient_sweep", "fri_fold", "poseidon2_bb")

LAUNCHES = {name: 0 for name in KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U64 = ctypes.c_uint64
_IP = ctypes.POINTER(ctypes.c_int)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_SIGNATURES = {
    "ntt": {
        # in, out, scale, L, heap, post, plan, passes, log_n, rows, stream
        "bt_ntt_forward": (_P, _P, _P, _I, _P, _P, _IP, _I, _I, _LL, _P),
        # in, out, heap, pre, plan, passes, log_n, rows, 1/n, stream
        "bt_ntt_inverse": (_P, _P, _P, _P, _IP, _I, _I, _LL, _U64, _P),
    },
    "poseidon2": {
        "bt_poseidon2_set_constants": (_P,),
        "bt_poseidon2_leaf_hash": (_P, _I, _LL, _P, _P),
        "bt_poseidon2_node_hash": (_P, _LL, _P, _P),
        "bt_poseidon2_permute": (_P, _LL, _P, _P),
        "bt_poseidon2_absorb": (_P, _P, _I, _LL, _P),
    },
    "quotient_sweep": {
        # 11 operand blocks; table, its length; program, its length;
        # constants, their count; Ct, chunk degree, alpha count, parts,
        # slots; n; rows a thread, threads, sub-threads a row; the two
        # outputs and the stream
        "bt_quotient_sweep": (*(_P,) * 12, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _LL,
                              _I, _I, _I, _P, _P, _P),
    },
    "fri_fold": {
        # c0, c1, outputs, rounds, 1/x, table shift, sub-challenges (c0,
        # c1, 7 c1 each), 2^-k, o0, o1, stream
        "bt_fri_fold_oracle": (_P, _P, _LL, _I, _P, _I, _U64P, _U64, _P, _P, _P),
    },
    "poseidon2_bb": {
        "bt_poseidon2_bb_set_constants": (_P, _I),
        "bt_poseidon2_bb_permute": (_P, _LL, _P, _P),
        "bt_poseidon2_bb_leaf": (_P, _I, _I, _LL, _LL, _LL, _P, _P),
        "bt_poseidon2_bb_node": (_P, _LL, _P, _LL, _LL, _P, _P),
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count(name: str) -> None:
    LAUNCHES[name] += 1


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(lib: str) -> Path:
    h = hashlib.sha256()
    for src in (CSRC / "goldilocks.cuh", CSRC / f"{lib}.cu"):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{lib}-{h.hexdigest()[:16]}.so"


def _start_build(lib: str):
    """Start nvcc for one library unless it is built; returns (path, proc)."""
    out = _library_path(lib)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           str(CSRC / f"{lib}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return out, (proc, tmp)


def _finish_build(lib: str, out: Path, job) -> None:
    if job is None:
        return
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{lib}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> dict[str, Path]:
    """Compile every library that is not built yet, all nvcc runs at once."""
    jobs = {lib: _start_build(lib) for lib in LIBRARIES}
    for lib, (out, job) in jobs.items():
        _finish_build(lib, out, job)
    return {lib: out for lib, (out, _job) in jobs.items()}


def library(lib: str) -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    if lib in _loaded:
        return _loaded[lib]
    out, job = _start_build(lib)
    _finish_build(lib, out, job)
    handle = ctypes.CDLL(str(out))
    for fn, argtypes in _SIGNATURES[lib].items():
        f = getattr(handle, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    _loaded[lib] = handle
    return handle


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed: cudaError {err}")


def ptr(t: torch.Tensor | None):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def int_array(values):
    """A C int array of `values`, for an argument declared int*."""
    return (ctypes.c_int * len(values))(*values)


def u64_array(values):
    """A C uint64_t array of `values`, for an argument declared uint64_t*."""
    return (ctypes.c_uint64 * len(values))(*values)


def stream(device: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require(t: torch.Tensor, what: str, shape=None, dtype=torch.int64) -> None:
    """Validate a kernel operand: of `dtype` (int64 Goldilocks words, int32
    BabyBear words), contiguous, and of the given shape."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype} words, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def same_device(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"operands on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev
