"""Build the native sources into shared libraries, at first use.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by nvcc for
Hopper (`sm_90a`) into `build/ide3d_tpu_torch/lib<name>-<hash>.so` at the root
of the checkout, then loaded with ctypes. Host C++ sources (the loader's
`data/_native/host_ops.cpp`) go the same way through g++. The hash is taken
over the source and the flags, so an edited source is rebuilt and an
unchanged one is reused. Nothing is built when this module is imported.
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
# No -march=native: build/ sits in the checkout, and a library built for one
# host's CPU can take SIGILL on another. No contraction into FMAs, so the host
# ops round as their numpy route does.
GXX_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC", "-ffp-contract=off"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise FileNotFoundError(f"nvcc not found on PATH or at {path}")
    return path


def _gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise FileNotFoundError("g++ not found on PATH")
    return found


def _compile(src: Path, compiler, flags: list) -> tuple[Path, str]:
    """Compile `src` with `compiler()` and `flags` unless a library of the same
    source and flags hash exists. Returns (library path, compiler log); the
    log is empty when the library was already built. Raises RuntimeError with
    the compiler's output if it fails."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}-{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [compiler(), *flags, "-o", tmp, str(src)],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(proc.args[0]).name} failed on {src} "
                               f"(rc {proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent process never loads a partial file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib, proc.stdout + proc.stderr


def build(name: str) -> tuple[Path, str]:
    """Compile csrc/<name>.cu with nvcc (see `_compile`)."""
    return _compile(CSRC / f"{name}.cu", _nvcc, NVCC_FLAGS)


def build_host(src: Path) -> tuple[Path, str]:
    """Compile the host C++ source `src` with g++ (see `_compile`)."""
    return _compile(Path(src), _gxx, GXX_FLAGS)


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; one handle per process."""
    lib, _ = build(name)
    return ctypes.CDLL(str(lib))
