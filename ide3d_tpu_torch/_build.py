"""Build the CUDA sources under csrc/ into shared libraries, at first use.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by nvcc for
Hopper (`sm_90a`) into `build/ide3d_tpu_torch/lib<name>-<hash>.so` at the root
of the checkout, then loaded with ctypes. The hash is taken over the source,
so an edited source is rebuilt and an unchanged one is reused. Nothing is
built when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "ide3d_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise FileNotFoundError(f"nvcc not found on PATH or at {path}")
    return path


def build(name: str) -> tuple[Path, str]:
    """Compile csrc/<name>.cu unless a library of the same source hash exists.

    Returns (library path, compiler log); the log is empty when the library
    was already built. Raises RuntimeError with nvcc's output if it fails.
    """
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} (rc {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent process never loads a partial file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib, proc.stdout + proc.stderr


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; one handle per process."""
    lib, _ = build(name)
    return ctypes.CDLL(str(lib))
