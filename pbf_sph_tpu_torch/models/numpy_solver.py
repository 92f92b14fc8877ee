"""Pure-NumPy oracle backend, the port's own copy.

Port of `pbf_sph_tpu/models/numpy_solver.py`, line for line on the port's
host types, constants, MC tables, Morton curve and NumPy kernels; it
imports nothing of `pbf_sph_tpu`.  It stays NumPy on the host: an oracle
re-expressed on torch would share the port's numerics and lose its
independence.  Chosen by name (`make_solver("numpy")`), never in place of a
device backend.

A from-scratch, vectorized re-expression of the reference pipeline
(one frame = reference `omp_impl::Solver::advance`, `src/omp/ompsph.hpp:85-485`)
used as a fidelity oracle for the device backends.  All arithmetic is fp32 by
default, matching the reference's `Solver<size_t, float>` benchmark
configuration (`src/benchmark.cpp:163`).

Deliberate divergences from the reference OMP backend (documented reference bugs):
  * obstacles follow the OCL backend semantics (pStar = position/scale, real
    zIndex, reference `src/ocl/oclsph.cpp:64-69`); the OMP backend's early
    `return` leaves obstacle scratch records default-initialized
    (`src/omp/ompsph.hpp:139`), which is unusable.
  * triangle emission order is deterministic cube-major instead of the
    reference's atomic-counter order (`src/ocl/oclsph_kernel.h:390`); the
    triangle *set* matches.
  * grid-cell skip rule follows the OMP oracle (`offset >= gridTableN`,
    `src/sph.hpp:207`), not the OCL kernel's off-by-one `>` (`src/ocl/
    oclsph_kernel.h:56`).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from pbf_sph_tpu_torch.core.constants import DEFAULT_CONSTANTS as K
from pbf_sph_tpu_torch.core.types import (
    FLUID,
    OBSTACLE,
    ColouredMesh,
    ParticleSoA,
    QueryResult,
    Result,
    Scene,
    SphParams,
)
from pbf_sph_tpu_torch.ops import mc_tables as mct
from pbf_sph_tpu_torch.ops.curves import morton_encode3
from pbf_sph_tpu_torch.ops.kernels import poly6, poly6_factor, spiky_gradient, spiky_kernel_factor
from pbf_sph_tpu_torch.models.solver import Solver

BIG = np.int64(1) << 40

# 27-cell stencil offsets, x fastest (reference `src/sph.hpp:220-234` order).
STENCIL = np.array(
    [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
    dtype=np.int64,
)


def _ragged_ranges(start: np.ndarray, count: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Expand per-row [start, start+count) ranges into flat (row, value) arrays."""
    total = int(count.sum())
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    rows = np.repeat(np.arange(len(count)), count)
    offs = np.arange(total) - np.repeat(np.cumsum(count) - count, count)
    return rows, offs + start[rows]


def _mix(x, y, a):
    """glm::mix / OpenCL mix: x + a*(y-x)."""
    return x + a * (y - x)


class NumpySolver(Solver):
    def __init__(self, h: float = 0.1, dtype=np.float32):
        super().__init__(h)
        self.dtype = np.dtype(dtype).type  # scalar type: accepts "float32" etc.

    # -- grid helpers -------------------------------------------------------

    def _cells_of(self, sim_pos: np.ndarray, min_extent: np.ndarray) -> np.ndarray:
        """Cell coords by C-style truncation-toward-zero of (p - minExtent)/h
        (reference `zCurveGridIndexAtCoordAt`, `src/sph.hpp:198-201`).
        May be negative/out-of-range; validity is resolved by the caller."""
        coords = (sim_pos - min_extent) / self.dtype(self.h)
        return np.trunc(coords).astype(np.int64)

    @staticmethod
    def _codes_of(cells: np.ndarray) -> np.ndarray:
        """Morton codes; invalid coords (the reference's size_t-wrap cases,
        which always produce codes >= gridTableN and get skipped) map to BIG."""
        valid = ((cells >= 0) & (cells <= 1023)).all(axis=1)
        safe = np.where(valid[:, None], cells, 0)
        z = morton_encode3(safe[:, 0], safe[:, 1], safe[:, 2])
        return np.where(valid, z, BIG)

    def _stencil_pairs(self, cells, codes, grid_table, maxz):
        """All (center a, neighbour b) pairs per the reference 27-cell walk
        (`foreach_grid`, `src/sph.hpp:203-236`)."""
        A_all: List[np.ndarray] = []
        B_all: List[np.ndarray] = []
        n = len(cells)
        center_ok = codes < maxz  # invalid centers gather nothing
        for d in STENCIL:
            nc = cells + d
            nz = self._codes_of(nc)
            ok = center_ok & (nz < maxz)
            nz_safe = np.where(ok, nz, 0)
            start = np.where(ok, grid_table[nz_safe], 0)
            end = np.where(ok & (nz_safe + 1 < maxz), grid_table[np.minimum(nz_safe + 1, maxz)], start)
            A, B = _ragged_ranges(start, end - start)
            A_all.append(A)
            B_all.append(B)
        return np.concatenate(A_all), np.concatenate(B_all)

    # -- the frame ----------------------------------------------------------

    def advance(self, config: SphParams, scene: Scene, xs: ParticleSoA):
        # per-phase Stopwatch (reference OMP prints one per frame,
        # src/omp/ompsph.hpp:89-482); cli --phase-timings prints it
        from pbf_sph_tpu_torch.utils.stopwatch import Stopwatch

        watch = Stopwatch("advance")
        self.last_watch = watch
        _stop = watch.start("sources_drains")
        f = self.dtype
        h = f(self.h)
        dt = f(config.dt)
        scale = f(config.scale)
        min_bound = np.asarray(config.min_bound, f)
        max_bound = np.asarray(config.max_bound, f)
        const_force = np.asarray(config.constant_force, f)

        xs = xs.copy()

        # 1. source emission (reference `src/omp/ompsph.hpp:93-105`)
        spacing = h * scale / f(2)
        spawned = [xs]
        for s in scene.sources:
            size = np.sqrt(f(s.rate))
            width = int(np.floor(size))
            depth = int(np.ceil(size))
            if width * depth == 0:
                continue
            offset = np.asarray(s.centre, f) - np.array([width, 0, depth], f) * f(0.5) * spacing
            gx, gz = np.meshgrid(np.arange(width), np.arange(depth), indexing="ij")
            grid = np.stack([gx.ravel(), np.zeros(width * depth), gz.ravel()], 1).astype(f)
            pos = offset + grid * spacing
            m = width * depth
            spawned.append(
                ParticleSoA(
                    pid=np.full(m, s.tag, np.int32),
                    ptype=np.full(m, FLUID, np.int32),
                    mass=np.ones(m, f),
                    position=pos,
                    velocity=np.broadcast_to(np.asarray(s.velocity, f), (m, 3)).copy(),
                    colour=np.broadcast_to(np.asarray(s.colour, f), (m, 4)).copy(),
                )
            )
        xs = ParticleSoA.concat(spawned)

        # 2. drain removal (reference `src/omp/ompsph.hpp:107-118`)
        if scene.drains:
            keep = np.ones(len(xs), bool)
            for d in scene.drains:
                dist = np.linalg.norm(xs.position - np.asarray(d.centre, f), axis=1)
                keep &= (xs.ptype == OBSTACLE) | (dist >= f(d.width))
            idx = np.nonzero(keep)[0]
            xs = ParticleSoA(
                xs.pid[idx], xs.ptype[idx], xs.mass[idx],
                xs.position[idx], xs.velocity[idx], xs.colour[idx],
            )
        if len(xs) == 0:
            # reference prints and early-outs (`src/omp/ompsph.hpp:122-126`)
            print("Particles depleted")
            _stop()
            return Result(), xs

        n = len(xs)
        fluid = xs.ptype == FLUID
        fl3 = fluid[:, None]

        _stop()
        _stop = watch.start("advect")
        # 3. advect + external forces (reference `src/omp/ompsph.hpp:130-155`)
        padding = h * f(2)
        min_extent = min_bound / scale - padding
        max_extent = max_bound / scale + padding
        extent = np.trunc((max_extent - min_extent) / h).astype(np.int64)
        maxz = int(morton_encode3(int(extent[0]), int(extent[1]), int(extent[2])))

        force = xs.mass[:, None] * const_force
        for w in scene.wells:
            centre = np.asarray(w.centre, f)
            diff = centre - xs.position
            dist = np.linalg.norm(diff, axis=1)
            near = dist < f(75)
            dist_safe = np.where(dist > 0, dist, 1).astype(f)
            rhat = diff / dist_safe[:, None]
            fw = np.clip(rhat * f(w.force) * xs.mass[:, None] / (dist_safe**2)[:, None], f(-10), f(10))
            force = force + np.where(near[:, None], fw, f(0))

        vel = np.where(fl3, xs.velocity + force * dt, xs.velocity)
        pstar = np.where(fl3, vel * dt + xs.position / scale, xs.position / scale)

        _stop()
        _stop = watch.start("sortz")
        # 4. cell assignment + 5. sort (reference `src/omp/ompsph.hpp:152-158`)
        cells = self._cells_of(pstar, min_extent)
        codes = self._codes_of(cells)
        key = np.where(codes < maxz, codes, BIG)
        order = np.argsort(key, kind="stable")

        pid = xs.pid[order]
        ptype = xs.ptype[order]
        mass = xs.mass[order]
        position = xs.position[order]
        colour = xs.colour[order].copy()
        vel = vel[order]
        pstar = pstar[order]
        cells = cells[order]
        codes = codes[order]
        key = key[order]
        fluid = ptype == FLUID
        fl3 = fluid[:, None]

        _stop()
        _stop = watch.start("gridtable")
        # 6. dense grid table (reference `makeGridTable`, `src/sph.hpp:238-250`):
        # gridTable[z] = first sorted index with code >= z == searchsorted-left.
        grid_table = np.searchsorted(key, np.arange(maxz + 1, dtype=np.int64), side="left")

        _stop()
        _stop = watch.start("queries")
        # 7. point queries, centre cell only (reference `src/omp/ompsph.hpp:167-186`)
        queries: List[QueryResult] = []
        for q in scene.queries:
            scaled = np.asarray(q.point, f) / scale - min_extent
            qcell = np.trunc(scaled / h).astype(np.int64)[None, :]
            zq = int(self._codes_of(qcell)[0])
            neigh = np.zeros(0, np.int32)
            if zq < maxz and zq + 1 < maxz:
                lo, hi = grid_table[zq], grid_table[zq + 1]
                seg = slice(lo, hi)
                neigh = pid[seg][ptype[seg] == FLUID].astype(np.int32)
            queries.append(QueryResult(q.id, np.asarray(q.point, f), neigh))

        _stop()
        _stop = watch.start("stencil_pairs")
        A, B = self._stencil_pairs(cells, codes, grid_table, maxz)

        def bc(vals, rows=None, length=n):
            rows = A if rows is None else rows
            if vals.ndim == 1:
                return np.bincount(rows, weights=vals, minlength=length).astype(f)
            return np.stack(
                [np.bincount(rows, weights=vals[:, i], minlength=length) for i in range(vals.shape[1])],
                axis=1,
            ).astype(f)

        _stop()
        _stop = watch.start("diffuse")
        # 8. colour diffusion (reference `src/omp/ompsph.hpp:188-207`)
        nb_fluid = ptype[B] != OBSTACLE
        cnt = np.bincount(A[nb_fluid], minlength=n)
        mixture = bc(colour[B] * nb_fluid[:, None])
        cnt_safe = np.maximum(cnt, 1).astype(f)
        mixed = _mix(colour, (mixture / cnt_safe[:, None]) * f(1.33), dt / f(750))
        upd = fluid & (cnt > 0)
        colour = np.where(upd[:, None], np.clip(mixed, f(0.03), f(1.0)), colour)

        _stop()
        _stop = watch.start("lambda_delta")
        # 9. constraint solve (reference `src/omp/ompsph.hpp:209-249`)
        p6f = f(poly6_factor(self.h))
        skf = f(spiky_kernel_factor(self.h))
        p6dq = poly6(np.asarray([f(K.CORR_DELTA_Q) * h]), h, p6f, np)[0]
        lam = np.zeros(n, f)
        for _ in range(int(config.iteration)):
            d = pstar[A] - pstar[B]
            r = np.linalg.norm(d, axis=1).astype(f)
            p6 = poly6(r, h, p6f, np)
            sg = spiky_gradient(d, r, h, skf, np)
            rho = bc(mass[A] * p6)
            norm2v = bc(sg * f(K.RHO_RECIP))
            norm2 = (norm2v**2).sum(1)
            ci = rho / f(K.RHO) - f(1)
            lam = np.where(fluid, -ci / (norm2 + f(K.CFM_EPSILON)), f(0))

            d = pstar[A] - pstar[B]
            r = np.linalg.norm(d, axis=1).astype(f)
            p6 = poly6(r, h, p6f, np)
            sg = spiky_gradient(d, r, h, skf, np)
            corr = f(-K.CORR_K) * (p6 / p6dq) ** f(K.CORR_N)
            factor = (lam[A] + lam[B] + corr) / f(K.RHO)
            dp = bc(sg * factor[:, None])
            moved = np.clip((pstar + dp) * scale, min_bound, max_bound) / scale
            pstar = np.where(fl3, moved, pstar)

        _stop()
        _stop = watch.start("finalise")
        # 10. finalise (reference `src/omp/ompsph.hpp:252-264`)
        delta_x = pstar - position / scale
        new_position = np.where(fl3, pstar * scale, position)
        new_vel = np.where(fl3, (delta_x * (f(1) / dt) + vel) * f(K.VD), vel)

        _stop()
        _stop = watch.start("mc")
        # 11. marching cubes (reference `src/omp/ompsph.hpp:277-477`)
        mesh = ColouredMesh.empty(f)
        if config.surface is not None:
            mesh = self._marching_cubes(
                config, new_position, colour, ptype, grid_table, maxz,
                min_extent, extent,
            )

        out = ParticleSoA(pid, ptype, mass, new_position, new_vel, colour)
        _stop()
        return Result(mesh=mesh, queries=queries), out

    # -- marching cubes ------------------------------------------------------

    def _marching_cubes(self, config, position, colour, ptype, grid_table, maxz, min_extent, extent):
        f = self.dtype
        h = f(self.h)
        scale = f(config.scale)
        surf = config.surface
        res = f(surf.resolution)
        iso = f(surf.isolevel)
        psize = f(surf.particle_size)
        pinfl = f(surf.particle_influence)
        step = h / res

        sample = (np.floor(extent.astype(f) * res) + 1).astype(np.int64)  # (3,)
        nx, ny, nz = (int(v) for v in sample)
        gx, gy, gz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
        node = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], 1).astype(np.int64)  # (L,3)
        L = node.shape[0]

        # lattice field (reference `src/omp/ompsph.hpp:288-356`)
        a_world = (min_extent + node.astype(f) * step) * scale
        threshold = h * scale
        node_cell = np.trunc(node.astype(f) / res).astype(np.int64)
        skip = (node_cell == extent).all(axis=1)  # the single far-corner case

        clo = np.clip(node_cell - 1, 0, extent - 1)
        chi = np.clip(node_cell + 1, 0, extent - 1)
        choices = np.stack([clo, node_cell, chi], axis=1)  # (L, 3choice, 3axis)

        v_acc = np.zeros(L, f)
        n_acc = np.zeros((L, 3), f)
        c_acc = np.zeros((L, 4), f)
        cnt = np.zeros(L, np.int64)
        for sel in [(i, j, k) for k in (0, 1, 2) for j in (0, 1, 2) for i in (0, 1, 2)]:
            sc = np.stack(
                [choices[:, sel[0], 0], choices[:, sel[1], 1], choices[:, sel[2], 2]], 1
            )
            zc = morton_encode3(sc[:, 0], sc[:, 1], sc[:, 2])
            ok = ~skip & (zc < maxz)
            zc_safe = np.where(ok, zc, 0)
            start = np.where(ok, grid_table[zc_safe], 0)
            end = np.where(ok & (zc_safe + 1 < maxz), grid_table[np.minimum(zc_safe + 1, maxz)], start)
            A, B = _ragged_ranges(start, end - start)
            if len(A) == 0:
                continue
            lvec = position[B] - a_world[A]
            dist = np.linalg.norm(lvec, axis=1).astype(f)
            use = (ptype[B] != OBSTACLE) & (dist < threshold)
            A, B, lvec, dist = A[use], B[use], lvec[use], dist[use]
            with np.errstate(divide="ignore", invalid="ignore"):
                denom = dist**pinfl
                v_acc += np.bincount(A, weights=psize / denom, minlength=L).astype(f)
                contrib = (-pinfl) * psize * (lvec / denom[:, None])
            for i in range(3):
                n_acc[:, i] += np.bincount(A, weights=contrib[:, i], minlength=L).astype(f)
            for i in range(4):
                c_acc[:, i] += np.bincount(A, weights=colour[B][:, i], minlength=L).astype(f)
            cnt += np.bincount(A, minlength=L)

        with np.errstate(divide="ignore", invalid="ignore"):
            n_norm = np.linalg.norm(n_acc, axis=1)
            normals = n_acc / n_norm[:, None]
            lat_c = c_acc / cnt[:, None].astype(f)
        lat_v = v_acc

        # case index + counts (reference `src/omp/ompsph.hpp:359-397`)
        march = sample - 1
        mx, my, mz = (int(v) for v in march)
        cgx, cgy, cgz = np.meshgrid(np.arange(mx), np.arange(my), np.arange(mz), indexing="ij")
        cube = np.stack([cgx.ravel(), cgy.ravel(), cgz.ravel()], 1)  # (M,3)
        M = cube.shape[0]

        def lin(p):
            return p[:, 0] * ny * nz + p[:, 1] * nz + p[:, 2]

        corner_idx = np.stack([lin(cube + off) for off in mct.CUBE_OFFSETS], 1)  # (M,8)
        vals = lat_v[corner_idx]  # (M,8)
        ci = np.zeros(M, np.int64)
        for i in range(8):
            ci |= (vals[:, i] < iso).astype(np.int64) << i
        ntris = np.where(mct.EDGE_TABLE[ci] == 0, 0, mct.NUM_VERTS_TABLE[ci] // 3)
        total = int(ntris.sum())
        if total == 0:
            return ColouredMesh.empty(f)

        offsets = np.cumsum(ntris) - ntris

        # edge interpolation (reference `src/omp/ompsph.hpp:399-474`)
        sel = np.nonzero(ntris > 0)[0]
        ci_s = ci[sel]
        cube_s = cube[sel]
        cidx_s = corner_idx[sel]
        vals_s = vals[sel]
        corner_pos = (
            min_extent + (cube_s[:, None, :] + mct.CUBE_OFFSETS[None, :, :]).astype(f) * step
        ) * scale  # (S,8,3)
        corner_nrm = normals[cidx_s]  # (S,8,3)
        corner_col = lat_c[cidx_s]  # (S,8,4)

        e_from = mct.EDGE_CORNERS[:, 0]
        e_to = mct.EDGE_CORNERS[:, 1]
        v0 = vals_s[:, e_from]  # (S,12)
        v1 = vals_s[:, e_to]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = ((iso - v0) / (v1 - v0)).astype(f)  # (S,12)
        ev = _mix(corner_pos[:, e_from], corner_pos[:, e_to], t[..., None])
        en = _mix(corner_nrm[:, e_from], corner_nrm[:, e_to], t[..., None])
        ec = _mix(corner_col[:, e_from], corner_col[:, e_to], t[..., None])

        vs = np.zeros((total * 3, 3), f)
        ns = np.zeros((total * 3, 3), f)
        cs = np.zeros((total * 3, 4), f)
        off_s = offsets[sel]
        ntris_s = ntris[sel]
        for ti in range(mct.MAX_TRIS_PER_CUBE):
            has = ntris_s > ti
            if not has.any():
                break
            rows = np.nonzero(has)[0]
            tri_edges = mct.TRI_TABLE[ci_s[rows], 3 * ti : 3 * ti + 3]  # (R,3)
            out_base = (off_s[rows] + ti) * 3
            for k in range(3):
                e = tri_edges[:, k]
                vs[out_base + k] = ev[rows, e]
                ns[out_base + k] = en[rows, e]
                cs[out_base + k] = ec[rows, e]
        return ColouredMesh(vs, ns, cs)
