"""boojum_tpu_torch: the PLONKish + FRI prover on PyTorch and CUDA.

A port of `boojum_tpu` (JAX on a TPU) to an NVIDIA H100, over Goldilocks
(int64 words) and over BabyBear (int32 words; a circuit names its field).
Plain tensor code is PyTorch; every kernel the JAX package wrote in Pallas
is a CUDA C++ kernel under `csrc/`, built with nvcc at first use. Entry points
take an explicit `device=` that defaults to "cuda" and raise when no card is
present; tests pass `device="cpu"`, where every kernel wrapper runs its plain
PyTorch version. The package imports neither jax nor boojum_tpu.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "boojum_tpu_torch: device 'cuda' requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
