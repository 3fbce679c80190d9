"""Build the port's CUDA kernels from `csrc/` at first use.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface, loaded with `ctypes`. The library goes
into `kernels/_build/` (ignored by git), named by a hash of the source and
flags, so an edited source is rebuilt and an unchanged one is reused. A
failed build raises; nothing falls back to the plain versions."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return str(path)


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of `csrc/<name>.cu`. The
    compiler's `-Xptxas -v` report (registers, shared memory, spills) is
    kept beside it as `<lib>.ptxas.txt`."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = BUILD_DIR / f"{lib.name}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src.name}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        Path(f"{lib}.ptxas.txt").write_text(proc.stderr)
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))
