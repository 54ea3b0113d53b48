"""boojum_tpu_torch stands alone: no jax, no boojum_tpu, and its entry points
run on the card unless the caller asks for the CPU."""

import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import boojum_tpu_torch
from torch_port_util import REPO

MODULES = sorted(
    m.name for m in pkgutil.walk_packages(boojum_tpu_torch.__path__, "boojum_tpu_torch.")
)


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_every_module_imports_without_jax_or_boojum_tpu():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'boojum_tpu' or m.startswith('boojum_tpu.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_clean_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert len(MODULES) >= 20
    # the sha256 slice's modules are among those imported
    assert {"boojum_tpu_torch.cs.lookup_table", "boojum_tpu_torch.gadgets.tables",
            "boojum_tpu_torch.gadgets.chunk_utils", "boojum_tpu_torch.gadgets.sha256",
            "boojum_tpu_torch.circuits"} <= set(MODULES)
    # and the BabyBear slice's
    assert {"boojum_tpu_torch.field.babybear", "boojum_tpu_torch.hashes.poseidon2_bb",
            "boojum_tpu_torch.ntt.bb_ntt", "boojum_tpu_torch.prover.prover_bb",
            "boojum_tpu_torch.prover.bb_prover", "boojum_tpu_torch.prover.bb_verifier",
            "boojum_tpu_torch.prover.stages_bb"} <= set(MODULES)
    # and witness resolution's
    assert {"boojum_tpu_torch.dag", "boojum_tpu_torch.dag.resolver",
            "boojum_tpu_torch.native"} <= set(MODULES)


def test_sources_name_no_jax_import():
    roots = [REPO / "boojum_tpu_torch", REPO / "chip_smoke.py"]
    files = [p for r in roots for p in ([r] if r.is_file() else r.rglob("*.py"))]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), f
            assert not s.startswith(("import boojum_tpu ", "from boojum_tpu ",
                                     "from boojum_tpu.", "import boojum_tpu.")), f


@pytest.mark.parametrize("entry", ["resolve_device", "generate_setup", "prove"])
def test_default_device_is_cuda_and_raises_without_one(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from boojum_tpu_torch import resolve_device
    from boojum_tpu_torch.prover import ProofConfig, generate_setup, prove

    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "resolve_device":
            resolve_device()
        elif entry == "generate_setup":
            generate_setup(object(), ProofConfig(fri_lde_factor=4))
        else:
            prove(object(), object(), ProofConfig(fri_lde_factor=4))


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                       env=_clean_env(), capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    # alone in a directory, without the package
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_kernel_table_names_every_wrapper():
    from boojum_tpu_torch import kernels as K

    assert set(K.LAUNCHES) == set(K.KERNELS)
    for name, (lib, replaces) in K.KERNELS.items():
        assert lib in K.LIBRARIES
        assert (K.CSRC / f"{lib}.cu").exists()
        assert replaces.startswith("boojum_tpu/")
    K.reset_launches()
    assert not any(K.LAUNCHES.values())
