"""Build and load the hand-written CUDA kernels of `pbf_sph_tpu_torch/csrc`.

At first use, `nvcc` compiles every `csrc/*.cu` into one shared library with
a plain C interface for Hopper (`sm_90a`), into `pbf_sph_tpu_torch/_build/`.
The library's name carries a hash of the sources and flags, so a changed
source builds anew and an unchanged one loads at once.  It is loaded with
`ctypes`; each launcher takes its pointers and the stream as `c_void_p` and
returns `cudaGetLastError()`, which `check` turns into an exception.

Nothing here runs at import: the CPU-only test machines have no `nvcc`.
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

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# launcher name -> argtypes, as declared in csrc/pbf_phases.cu
SIGNATURES = {
    "pbf_lambda": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _P, _P],
    "pbf_delta": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _P, _P],
    "pbf_diffuse": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


def library_path() -> Path:
    sources = sorted(SRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libpbf_phases_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library of the same hash exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = [str(s) for s in sorted(SRC_DIR.glob("*.cu"))]
    # build under a temporary name and rename, so a concurrent process never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
