"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

A source ``csrc/<name>.cu`` is compiled, on first use in a process, into a
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/tpuflow_torch/lib<name>-<hash>.so <src>

The library's name carries a hash of the source and the flags, so a
changed source is rebuilt and an unchanged one is reused. No PyTorch
headers are included, so a build takes seconds. ``-use_fast_math`` is
left out on purpose: it would break parity with the plain versions.
A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "tpuflow_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
        if candidate.exists():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (searched PATH and $CUDA_HOME/bin); the port's CUDA "
            "kernels are built from source at first use"
        )
    return nvcc


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, compiled first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = _libs[name] = ctypes.CDLL(str(out))
    return lib
