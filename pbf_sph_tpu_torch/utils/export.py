"""Result export: PLY point cloud + OBJ mesh, and state checkpoints.

Copy of `pbf_sph_tpu/utils/export.py`, which implements the behaviour the
reference documents for `--output` ("cloud.ply, mesh.obj", reference
`src/args.cpp:38-43`) but never implemented (`save()` stub, reference
`src/sph.hpp:188-196`).  The files are byte for byte the JAX package's for
the same arrays, and the checkpoints are its `.npz` format.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pbf_sph_tpu_torch.core.types import ColouredMesh, ParticleSoA, Result


def save_ply_points(path, xs: ParticleSoA) -> None:
    """Binary-less ASCII PLY point cloud with colours."""
    n = len(xs)
    col = np.clip(xs.colour[:, :3] * 255.0, 0, 255).astype(np.uint8)
    with open(path, "w") as fh:
        fh.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {n}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p, c in zip(xs.position, col):
            fh.write(f"{p[0]:.6g} {p[1]:.6g} {p[2]:.6g} {c[0]} {c[1]} {c[2]}\n")


def save_obj_mesh(path, mesh: ColouredMesh) -> None:
    """OBJ triangle soup with normals (one v/vn per emitted vertex)."""
    with open(path, "w") as fh:
        fh.write("# pbf-sph-tpu surface mesh\n")
        for v in mesh.vs:
            fh.write(f"v {v[0]:.6g} {v[1]:.6g} {v[2]:.6g}\n")
        for v in mesh.ns:
            fh.write(f"vn {v[0]:.6g} {v[1]:.6g} {v[2]:.6g}\n")
        for t in range(len(mesh.vs) // 3):
            a, b, c = 3 * t + 1, 3 * t + 2, 3 * t + 3
            fh.write(f"f {a}//{a} {b}//{b} {c}//{c}\n")


def save(result: Result, xs: ParticleSoA, out_dir: str) -> None:
    """Write cloud.ply + mesh.obj to `out_dir` (created if missing)."""
    path = Path(out_dir)
    path.mkdir(parents=True, exist_ok=True)
    save_ply_points(path / "cloud.ply", xs)
    save_obj_mesh(path / "mesh.obj", result.mesh)


# --- checkpoint / resume (new capability beyond the reference) --------------
# The JAX package's format: a checkpoint written by either package resumes in
# the other.


def save_checkpoint(path, xs: ParticleSoA, frame: int) -> None:
    np.savez_compressed(
        path,
        frame=frame,
        pid=xs.pid, ptype=xs.ptype, mass=xs.mass,
        position=xs.position, velocity=xs.velocity, colour=xs.colour,
    )


def load_checkpoint(path):
    d = np.load(path)
    xs = ParticleSoA(
        pid=d["pid"], ptype=d["ptype"], mass=d["mass"],
        position=d["position"], velocity=d["velocity"], colour=d["colour"],
    )
    return xs, int(d["frame"])
