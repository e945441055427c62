"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

A source ``csrc/<name>.cu`` is compiled, on first use in a process, into a
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/tpuflow_torch/lib<name>-<hash>.so <src>

The library's name carries a hash of the source and the flags, so a
changed source is rebuilt and an unchanged one is reused. No PyTorch
headers are included, so a build takes seconds. ``-use_fast_math`` is
left out on purpose: it would break parity with the plain versions.
A failed build raises; there is no fallback. :func:`build` compiles
several sources at once, one ``nvcc`` process each.
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


def _paths(name: str) -> tuple[pathlib.Path, pathlib.Path]:
    """(source, library) of ``name``; the library's name carries a hash
    of the source and the flags."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(*names: str) -> None:
    """Compile every library among ``names`` that is not built yet: one
    ``nvcc`` per source, all started together. Raises on any failure."""
    pending = []
    for name in names:
        src, out = _paths(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        pending.append((proc, cmd, tmp, out))
    failures = []
    for proc, cmd, tmp, out in pending:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{' '.join(cmd)}\n{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, compiled first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build(name)
        lib = _libs[name] = ctypes.CDLL(str(_paths(name)[1]))
    return lib
