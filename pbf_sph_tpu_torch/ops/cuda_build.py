"""Build and load the hand-written CUDA kernels of `pbf_sph_tpu_torch/csrc`.

At first use, `nvcc` compiles every `csrc/*.cu` for Hopper (`sm_90a`), one
process per source, all started together, and links the objects into one
shared library with a plain C interface, in `pbf_sph_tpu_torch/_build/`.
The library's name carries a hash of the sources, the headers they share
(`csrc/*.cuh`) and the flags, so a changed source builds anew and an
unchanged one loads at once.  It is loaded with `ctypes`; each launcher takes its pointers and the stream as `c_void_p` and
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# launcher name -> argtypes, as declared in csrc/*.cu
SIGNATURES = {
    # csrc/pbf_phases.cu
    "pbf_lambda": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _P, _P],
    "pbf_delta": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _P, _P],
    "pbf_diffuse": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    # csrc/pbf_diffuse_cells.cu
    "pbf_diffuse_cell_sums": [_P, _P, _P, _P, _I, _I, _P, _P],
    "pbf_diffuse_cells": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    # csrc/pbf_cells.cu, and csrc/cells_staged.cu's staged walk of the same
    **dict.fromkeys(("pbf_lambda_cells", "pbf_lambda_cells_staged"),
                    [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _P, _P]),
    **dict.fromkeys(("pbf_delta_cells", "pbf_delta_cells_staged"),
                    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F,
                     _P, _P]),
    # csrc/pbf_tiles.cu
    "pbf_lambda_tile": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _P, _P],
    "pbf_delta_tile": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _P, _P],
    **dict.fromkeys(
        ("pbf_lambda_tile_cull", "pbf_delta_tile_cull"),
        [_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _P, _P]),
    # csrc/mc_field.cu: the production body and the three bisection bodies
    **dict.fromkeys(
        ("mc_field", "mc_field_noop", "mc_field_rows", "mc_field_loops"),
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _P, _P]),
    # and the noop body's redesign (mc_field_zero_fill_ctas returns a CTA count)
    "mc_field_zero_fill_ctas": [],
    "mc_field_zero_fill": [_P, _I, _I, _P],
    # csrc/mc_field_cells.cu: row 4's redesign, the main path's MC field
    # (mc_field_cells_lanes() returns the build's G, the lanes a node)
    "mc_field_cells_lanes": [],
    "mc_field_cells": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _F, _F, _F, _F, _F, _P, _P],
    # csrc/pbf_phases2.cu
    "pbf_compact": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P],
    "pbf_lambda2": [_P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _F, _F, _P, _P],
    "pbf_delta2": [_P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _F, _F, _P, _P],
    "pbf_lambda2_cull": [_P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _P, _P],
    "pbf_delta2_cull": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _P, _P],
    "pbf_diffuse2": [_P, _P, _P, _P, _I, _I, _F, _F, _P, _P],
    "pbf_diffuse2_cull": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _P, _P],
    # csrc/anchor_rate.cu (anchor_fill_threads returns a thread count)
    "anchor_fill_threads": [_I, _I, _I, _I, _I],
    "anchor_issue": [_P, _I, _I, _I, _I, _I, _P, _P],
    **dict.fromkeys(("anchor_body", "anchor_body_blocked"),
                    [_P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _I, _P, _P]),
    "anchor_rowfix": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _P, _P],
    # csrc/micro_window.cu
    **dict.fromkeys(("window_prod", "window_guarded", "window_prod_blocked",
                     "window_guarded_blocked"),
                    [_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _P, _P]),
    **dict.fromkeys(("window_flat", "window_flat_blocked"),
                    [_P, _I, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _P, _P]),
    **dict.fromkeys(("window_static", "window_static_blocked"),
                    [_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _P, _P]),
    # csrc/micro_chunk.cu (micro_chunk_fill returns a CTA count)
    "micro_chunk_fill": [_I, _I, _I],
    "chunk_bench": [_P, _P, _I, _I, _F, _I, _I, _I, _F, _F, _F, _F, _F, _F, _I, _I, _P, _P],
    "chunk_fma": [_P, _I, _I, _I, _P, _P],
    # csrc/micro_loop.cu (micro_loop_fill returns a CTA count)
    "micro_loop_fill": [_I, _I],
    **dict.fromkeys(("loop_fma", "loop_chain", "loop_op"), [_P, _I, _I, _I, _I, _P, _P]),
    # csrc/micro_dense.cu
    "dense_loop": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _P, _P],
    "dense_mxu": [_P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _P, _P],
    "dense_scr": [_P, _P, _I, _I, _I, _I, _F, _F, _F, _P, _P],
    # csrc/micro_roll.cu (micro_roll_fill returns a copy count, or for
    # roll_part_blocked a CTA count; roll_part_blocked_chunks its CTAs a copy)
    "micro_roll_fill": [_I, _I],
    "roll_part_blocked_chunks": [_P, _I, _I, _I],
    "roll_lanes": [_P, _P, _I, _I, _I, _I, _P, _P],
    **dict.fromkeys(("roll_part", "roll_part_blocked"),
                    [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P]),
    "roll_lam": [_P, _P, _I, _I, _I, _F, _F, _F, _P, _P],
    "vpu_rot": [_P, _P, _P, _P],
    **dict.fromkeys(("vpu_unal", "vpu_dma"), [_P, _I, _P, _P]),
    # csrc/micro_vpu.cu (micro_vpu_fill returns a CTA count)
    "micro_vpu_fill": [_I, _I, _I],
    "vpu_streams": [_P, _I, _I, _I, _I, _I, _P, _P],
    **dict.fromkeys(("vpu_dot", "vpu_dot2"), [_P, _P, _I, _I, _P, _P]),
    "vpu_tr": [_P, _I, _I, _I, _P, _P],
    **dict.fromkeys(("vpu_dot_spread", "vpu_dot2_spread"), [_P, _P, _I, _I, _P, _P]),
    "vpu_tr_split": [_P, _I, _I, _I, _P, _P],
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
    sources = sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))
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
    nvcc = find_nvcc()
    # build in a temporary directory and rename the library into place, so a
    # concurrent process never loads a half-written one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        compiles = []
        for src in sorted(SRC_DIR.glob("*.cu")):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", os.path.join(tmp, src.stem + ".o"),
                   str(src)]
            compiles.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = [proc.communicate()[0] for _, proc in compiles]  # wait for all
        objects = []
        for (cmd, proc), log in zip(compiles, logs):
            _check_nvcc(cmd, proc.returncode, log)
            objects.append(cmd[cmd.index("-o") + 1])
        lib = os.path.join(tmp, out.name)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objects]
        res = subprocess.run(cmd, capture_output=True, text=True)
        _check_nvcc(cmd, res.returncode, res.stdout + res.stderr)
        os.replace(lib, out)
    return out


def _check_nvcc(cmd, returncode: int, log: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}): {' '.join(cmd)}\n{log}")


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
