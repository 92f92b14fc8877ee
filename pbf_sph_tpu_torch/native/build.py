"""Build the port's C++/OpenMP oracle with g++ into a shared library with a
plain C interface, loaded with ctypes (`models/cpp_solver.py`).

Port of `pbf_sph_tpu/native/build.py`: the same source (the port's copy,
`csrc/ompsph.cpp`), the same flags and the same two entries, `pbf_advance`
(fp32) and `pbf_advance_f64` (`-DSPH_REAL=double`).  The MC lookup tables
are generated into a header from the port's `ops/mc_tables.py`, so the
oracle and the port share their constants.  The library goes into
`pbf_sph_tpu_torch/_build/` under a name hashed from the source, the header,
the flags and the host CPU (`-march=native` builds for it), and is built at
first use; nothing runs at import.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
CSRC = HERE / "csrc"
BUILD = HERE.parent / "_build"

CXX_FLAGS = [
    "-O3", "-std=c++17", "-fPIC", "-fopenmp",
    "-march=native", "-ffast-math", "-fno-finite-math-only",
]
# (object stem, extra flags): fp32 `pbf_advance` and fp64 `pbf_advance_f64`
# (the reference OMP backend's --fp64 switch, src/benchmark.cpp:159-165);
# anonymous-namespace internals have internal linkage, so no clashes
ENTRIES = (
    ("ompsph32", []),
    ("ompsph64", ["-DSPH_REAL=double", "-DPBF_ENTRY=pbf_advance_f64"]),
)


def tables_header() -> str:
    """The text of `mc_tables.h`, from `ops/mc_tables.py`."""
    from pbf_sph_tpu_torch.ops import mc_tables as m

    lines = [
        "// generated from pbf_sph_tpu_torch/ops/mc_tables.py — do not edit",
        "#pragma once",
        "#include <cstdint>",
    ]

    def arr1(name, a):
        body = ",".join(str(int(v)) for v in a)
        lines.append(f"static const int32_t {name}[{len(a)}] = {{{body}}};")

    def arr2(name, a):
        rows = ",".join("{" + ",".join(str(int(v)) for v in row) + "}" for row in a)
        lines.append(
            f"static const int32_t {name}[{a.shape[0]}][{a.shape[1]}] = {{{rows}}};"
        )

    arr1("EDGE_TABLE", m.EDGE_TABLE)
    arr1("NUM_VERTS_TABLE", m.NUM_VERTS_TABLE)
    arr2("TRI_TABLE", m.TRI_TABLE)
    arr2("CUBE_OFFSETS", m.CUBE_OFFSETS)
    arr2("EDGE_CORNERS", m.EDGE_CORNERS)
    return "\n".join(lines) + "\n"


def host_cpu() -> str:
    """The host CPU as `-march=native` sees it: the first processor's
    vendor, family, model, model name and flags from /proc/cpuinfo (the
    machine's architecture where that file is missing)."""
    keys = ("vendor_id", "cpu family", "model", "model name", "flags")
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                key, _, val = line.partition(":")
                info[key.strip()] = val.strip()
    except OSError:
        pass
    return "\n".join(f"{k}: {info[k]}" for k in keys if k in info) or os.uname().machine


def library_path(header: str) -> Path:
    src = CSRC / "ompsph.cpp"
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + src.read_bytes() + header.encode()
                            + host_cpu().encode())
    return BUILD / f"libompsph_{digest.hexdigest()[:16]}.so"


def build_oracle(force: bool = False) -> Path:
    """Compile (unless a library of the same hash exists) and return the
    shared library's path.  Both objects compile at once, in a temporary
    directory; the library is renamed into place, so a concurrent process
    never loads a half-written one."""
    header = tables_header()
    lib = library_path(header)
    if lib.exists() and not force:
        return lib
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        Path(tmp, "mc_tables.h").write_text(header)
        procs = []
        for stem, extra in ENTRIES:
            obj = os.path.join(tmp, stem + ".o")
            cmd = ["g++", *CXX_FLAGS, f"-I{tmp}", *extra, "-c", str(CSRC / "ompsph.cpp"),
                   "-o", obj]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = [proc.communicate()[0] for _, _, proc in procs]  # wait for both
        for (cmd, _, proc), log in zip(procs, logs):
            _check(cmd, proc.returncode, log)
        out = os.path.join(tmp, lib.name)
        cmd = ["g++", "-shared", "-fopenmp", *(obj for _, obj, _ in procs), "-o", out]
        res = subprocess.run(cmd, capture_output=True, text=True)
        _check(cmd, res.returncode, res.stdout + res.stderr)
        os.replace(out, lib)
    return lib


def _check(cmd, returncode: int, log: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"g++ failed ({returncode}): {' '.join(cmd)}\n{log}")
