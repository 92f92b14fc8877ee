"""C++/OpenMP oracle backend (ctypes binding), the port's own copy.

Port of `pbf_sph_tpu/models/cpp_solver.py` over the port's library
(`native/build.py`, `native/csrc/ompsph.cpp`): the same argument list,
`PHASES` and `last_watch`.  It runs on the host, imports nothing of
`pbf_sph_tpu`, and is chosen by name (`make_solver("cpp")`), never in
place of a device backend.

The native fidelity anchor: loop-faithful sequential fp32 accumulation, the
equivalent of the reference's OpenMP backend (`src/omp/ompsph.hpp`).
"""

from __future__ import annotations

import ctypes as ct

import numpy as np

from pbf_sph_tpu_torch.core.types import (
    ColouredMesh,
    ParticleSoA,
    QueryResult,
    Result,
    Scene,
    SphParams,
)
from pbf_sph_tpu_torch.models.solver import Solver

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _load_lib(dtype=np.float32):
    """Bind the fp32 `pbf_advance` or fp64 `pbf_advance_f64` entry (the
    reference OMP backend's --fp64 switch, `src/benchmark.cpp:159-165`)."""
    from pbf_sph_tpu_torch.native.build import build_oracle

    lib = ct.CDLL(str(build_oracle()))
    if np.dtype(dtype) == np.float64:
        fn = lib.pbf_advance_f64
        c_real = ct.c_double
    else:
        fn = lib.pbf_advance
        c_real = ct.c_float
    _fp = np.ctypeslib.ndpointer(np.dtype(dtype), flags="C_CONTIGUOUS")
    fn.restype = ct.c_int
    fn.argtypes = [
        c_real, c_real, c_real, ct.c_int, _fp,  # h dt scale iter force
        _fp, _fp,  # bounds
        ct.c_int, c_real, c_real, c_real, c_real,  # surface
        ct.c_int, _fp, _fp,  # wells
        ct.c_int, _fp, _fp, _fp, _i32p, _fp,  # sources
        ct.c_int, _fp, _fp,  # drains
        ct.c_int, _fp,  # queries
        ct.c_int, _i32p, _i32p, _fp, _fp, _fp, _fp,  # particles in
        ct.c_int, _i32p, _i32p, _fp, _fp, _fp, _fp, _i32p,  # out
        ct.c_int, _fp, _fp, _fp, _i32p,  # mesh out
        ct.c_int, _i32p, _i32p,  # query out
        _i32p,  # stats
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),  # phase ms
    ]
    return fn


PHASES = ("sources", "drains", "advect", "sortz", "gridtable", "queries",
          "diffuse", "lambda_delta", "finalise", "mc_field", "mc_emit",
          "writeback")


class CppSolver(Solver):
    def __init__(self, h: float = 0.1, dtype: str = "float32",
                 query_capacity: int = 128, tri_capacity: int = 0):
        super().__init__(h)
        self.dtype = np.dtype(dtype)
        if self.dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
            raise ValueError(f"unsupported dtype {dtype}")
        self.query_capacity = int(query_capacity)
        self.tri_capacity = int(tri_capacity)
        self._fn = _load_lib(self.dtype)
        # per-phase table of the LAST advance() (reference OMP prints a
        # Stopwatch per frame, src/omp/ompsph.hpp:482); cli --phase-timings
        # prints it
        self.last_watch = None

    def advance(self, config: SphParams, scene: Scene, xs: ParticleSoA):
        f = self.dtype.type
        n = len(xs)
        total_spawn = 0
        for s in scene.sources:
            size = float(np.sqrt(np.float32(s.rate)))
            total_spawn += int(np.floor(size)) * int(np.ceil(size))
        cap = max(1, n + total_spawn)

        def farr(vals, shape):
            return np.ascontiguousarray(np.asarray(vals, f).reshape(shape))

        wells_c = farr([w.centre for w in scene.wells] or np.zeros((0, 3)), (-1, 3))
        wells_f = farr([w.force for w in scene.wells] or np.zeros(0), (-1,))
        src_c = farr([s.centre for s in scene.sources] or np.zeros((0, 3)), (-1, 3))
        src_v = farr([s.velocity for s in scene.sources] or np.zeros((0, 3)), (-1, 3))
        src_col = farr([s.colour for s in scene.sources] or np.zeros((0, 4)), (-1, 4))
        src_tag = np.ascontiguousarray(
            np.asarray([s.tag for s in scene.sources] or [], np.int32)
        )
        src_rate = farr([s.rate for s in scene.sources] or np.zeros(0), (-1,))
        drain_c = farr([d.centre for d in scene.drains] or np.zeros((0, 3)), (-1, 3))
        drain_w = farr([d.width for d in scene.drains] or np.zeros(0), (-1,))
        q_p = farr([q.point for q in scene.queries] or np.zeros((0, 3)), (-1, 3))

        surface = config.surface
        tri_cap = self.tri_capacity
        if surface is not None and tri_cap <= 0:
            # conservative: ~1 triangle/cube (grown on overflow below)
            from pbf_sph_tpu_torch.ops.grid import GridSpec
            from pbf_sph_tpu_torch.ops.mc import McSpec

            grid = GridSpec.from_bounds(config.min_bound, config.max_bound, config.scale, self.h)
            tri_cap = McSpec.from_extent(grid.extent, surface.resolution).tri_capacity
        tri_cap = max(1, tri_cap)

        qcap = self.query_capacity
        nq = len(scene.queries)

        for _attempt in range(4):
            o_pid = np.zeros(cap, np.int32)
            o_ptype = np.zeros(cap, np.int32)
            o_mass = np.zeros(cap, f)
            o_pos = np.zeros((cap, 3), f)
            o_vel = np.zeros((cap, 3), f)
            o_col = np.zeros((cap, 4), f)
            n_out = np.zeros(1, np.int32)
            o_vs = np.zeros((tri_cap * 3, 3), f)
            o_ns = np.zeros((tri_cap * 3, 3), f)
            o_cs = np.zeros((tri_cap * 3, 4), f)
            n_tris = np.zeros(1, np.int32)
            o_qids = np.zeros((max(nq, 1), qcap), np.int32)
            o_qcounts = np.zeros(max(nq, 1), np.int32)
            occ = np.zeros(1, np.int32)
            phase_ms = np.zeros(12, np.float64)

            rc = self._fn(
                f(self.h), f(config.dt), f(config.scale), int(config.iteration),
                farr(config.constant_force, (3,)),
                farr(config.min_bound, (3,)), farr(config.max_bound, (3,)),
                1 if surface else 0,
                f(surface.resolution if surface else 0),
                f(surface.isolevel if surface else 0),
                f(surface.particle_size if surface else 0),
                f(surface.particle_influence if surface else 0),
                len(scene.wells), wells_c, wells_f,
                len(scene.sources), src_c, src_v, src_col, src_tag, src_rate,
                len(scene.drains), drain_c, drain_w,
                nq, q_p,
                n,
                np.ascontiguousarray(xs.pid.astype(np.int32)),
                np.ascontiguousarray(xs.ptype.astype(np.int32)),
                np.ascontiguousarray(xs.mass.astype(f)),
                np.ascontiguousarray(xs.position.astype(f)),
                np.ascontiguousarray(xs.velocity.astype(f)),
                np.ascontiguousarray(xs.colour.astype(f)),
                cap, o_pid, o_ptype, o_mass, o_pos, o_vel, o_col, n_out,
                tri_cap, o_vs, o_ns, o_cs, n_tris,
                qcap, o_qids, o_qcounts,
                occ, phase_ms,
            )
            if rc == 0:
                from pbf_sph_tpu_torch.utils.stopwatch import Stopwatch

                self.last_watch = Stopwatch.from_durations(
                    "advance", list(zip(PHASES, phase_ms.tolist())))
                break
            tri_cap = max(tri_cap * 2, int(n_tris[0]) + 1024)
        else:
            raise RuntimeError("cpp oracle capacity growth did not converge")

        m = int(n_out[0])
        out = ParticleSoA(
            o_pid[:m], o_ptype[:m], o_mass[:m], o_pos[:m], o_vel[:m], o_col[:m]
        )
        t = int(n_tris[0])
        mesh = (
            ColouredMesh(o_vs[: t * 3], o_ns[: t * 3], o_cs[: t * 3])
            if surface
            else ColouredMesh.empty(f)
        )
        queries = [
            QueryResult(
                id=q.id,
                point=np.asarray(q.point, f),
                neighbours=o_qids[i, : int(o_qcounts[i])].copy(),
            )
            for i, q in enumerate(scene.queries)
        ]
        return Result(mesh=mesh, queries=queries), out
