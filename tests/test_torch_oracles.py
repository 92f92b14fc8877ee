"""The port's host oracles (`models/numpy_solver.py`, `models/cpp_solver.py`
over `native/`) and the backends that reach them, on the CPU.

* The port's NumpySolver and CppSolver equal the JAX package's bit for bit,
  in float32 and float64, on 2 frames with motion of the 700-particle
  2-cube scene with its surface (mesh included) and on one frame of
  `test_jax_vs_oracle.py`'s well/source/drain/query scene at 700
  particles.  The C++ oracles are the same source built with the same
  flags, and both emit cube-major with no atomics (`ompsph.cpp:13`).
* The port's generated `mc_tables.h` equals the JAX build's text apart from
  the comment line that names its source.
* `TorchSolver(device="cpu")`, kernel and gather backends, against the
  port's NumpySolver under `test_jax_vs_oracle.py`'s single-frame
  tolerances (position and velocity atol 0.02, colour 1e-3) and its mesh
  criterion (triangles within max(3, 1%), centroid IoU > 0.95).
* `make_solver("numpy"|"cpp")` takes no device other than the CPU; the CLI
  runs both oracles (and cpp's fp64 entry, with its phase table) without a
  card and refuses `--multichip` for them; the visualise loop through the
  C++ oracle writes the JAX loop's files byte for byte.
* The C++ oracle gives the same bits twice in one process, fp32 and fp64;
  its library's name hashes the host CPU, as it builds `-march=native`.

torch runs on one intra-op thread in this module.
"""

import functools

import numpy as np
import pytest
import torch

from pbf_sph_tpu import visualise as jvis
from pbf_sph_tpu.core import scene as jscene
from pbf_sph_tpu.core import types as jtypes
from pbf_sph_tpu.models.cpp_solver import CppSolver as JCpp
from pbf_sph_tpu.models.numpy_solver import NumpySolver as JNumpy
from pbf_sph_tpu.native import build as jbuild
from pbf_sph_tpu_torch import cli, visualise
from pbf_sph_tpu_torch.core import scene as tscene
from pbf_sph_tpu_torch.core import types as ttypes
from pbf_sph_tpu_torch.models import make_solver
from pbf_sph_tpu_torch.models import torch_solver as ts
from pbf_sph_tpu_torch.models.cpp_solver import PHASES, CppSolver
from pbf_sph_tpu_torch.models.numpy_solver import NumpySolver
from pbf_sph_tpu_torch.native import build

FIELDS = ("pid", "ptype", "mass", "position", "velocity", "colour")
ORACLES = {"numpy": (NumpySolver, JNumpy), "cpp": (CppSolver, JCpp)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the tier runs several test
    processes at once, and torch's default pool in each of them
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def two_cubes(pkg, n=700, iters=2):
    mc, cfg, xs = pkg.simple_config_with_2_cubes(n, iters, 500.0)
    return cfg.replace(surface=mc), xs


def scene_of(types):
    """`test_jax_vs_oracle.py:100-105`'s scene in the package of `types`."""
    return types.Scene(
        wells=[types.Well(tag=0, centre=(150.0, 30.0, 150.0), force=200.0)],
        sources=[types.Source(tag=777, centre=(500, 400, 500), velocity=(0, 1, 0),
                              colour=(1, 0, 0, 1), rate=9)],
        drains=[types.Drain(tag=0, centre=(650, 60, 650), width=80.0)],
        queries=[types.Query(id=3, point=(150, 30, 150))],
    )


@functools.lru_cache(maxsize=None)
def run(solver_cls, dtype: str, case: str, pkg_name: str):
    """[(result, xs)] of each frame of `case` through `solver_cls`: "motion"
    = 2 frames with motion of the 2-cube scene with its surface, "scene" = one
    frame of the well/source/drain/query scene, both at 700 particles."""
    pkg, types = (jscene, jtypes) if pkg_name == "jax" else (tscene, ttypes)
    solver = solver_cls(h=0.1, dtype=dtype)
    out = []
    if case == "motion":
        cfg, xs = two_cubes(pkg)
        for f in range(2):
            res, xs = solver.advance(pkg.apply_motion_sin_x_cos_z(cfg, f), types.Scene(), xs)
            out.append((res, xs))
    else:
        _, cfg, xs = pkg.simple_config_with_2_cubes(700, 3, 500.0)
        out.append(solver.advance(cfg, scene_of(types), xs))
    return out


@pytest.mark.parametrize("case", ["motion", "scene"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("impl", sorted(ORACLES))
def test_oracle_bit_for_bit_jax(impl, dtype, case):
    port_cls, jax_cls = ORACLES[impl]
    got, want = run(port_cls, dtype, case, "port"), run(jax_cls, dtype, case, "jax")
    for (gr, gx), (wr, wx) in zip(got, want):
        assert gx.position.dtype == np.dtype(dtype) and len(gx) == len(wx) > 0
        for k in FIELDS:
            assert np.array_equal(getattr(gx, k), getattr(wx, k)), k
        for k in ("vs", "ns", "cs"):
            assert np.array_equal(getattr(gr.mesh, k), getattr(wr.mesh, k), equal_nan=True), k
        assert [(q.id, q.neighbours.tolist()) for q in gr.queries] == \
            [(q.id, q.neighbours.tolist()) for q in wr.queries]
    if case == "motion":
        assert len(got[-1][0].mesh.vs) > 0
    else:
        assert len(got[0][0].queries) == 1 and len(got[0][0].queries[0].neighbours) > 0


def test_tables_header_matches_jax_build():
    got, want = build.tables_header().splitlines(), jbuild._tables_header().splitlines()
    assert got[0] == "// generated from pbf_sph_tpu_torch/ops/mc_tables.py — do not edit"
    assert got[1:] == want[1:] and len(got) == 8


def test_cpp_phase_table():
    solver = CppSolver(h=0.1)
    assert solver.last_watch is None
    cfg, xs = two_cubes(tscene)
    solver.advance(cfg, ttypes.Scene(), xs)
    text = str(solver.last_watch)
    assert all(f"`{p}`" in text for p in PHASES) and len(PHASES) == 12


def assert_state_close(a, b, pos_atol=0.02, vel_atol=0.02, col_atol=1e-3):
    """`test_jax_vs_oracle.py:30-35`, single-frame tolerances by default."""
    np.testing.assert_array_equal(a.pid, b.pid)
    np.testing.assert_array_equal(a.ptype, b.ptype)
    np.testing.assert_allclose(a.position, b.position, atol=pos_atol, rtol=0)
    np.testing.assert_allclose(a.velocity, b.velocity, atol=vel_atol, rtol=0)
    np.testing.assert_allclose(a.colour, b.colour, atol=col_atol, rtol=0)


def assert_mesh_close(a, b):
    """`test_jax_vs_oracle.py:135-148`: triangle counts within max(3, 1%),
    centroid sets at 0.1 with IoU > 0.95."""
    ta, tb = len(a.vs) // 3, len(b.vs) // 3
    assert ta > 0 and abs(ta - tb) <= max(3, 0.01 * tb), (ta, tb)

    def centroids(mesh):
        c = mesh.vs.reshape(-1, 3, 3).mean(axis=1)
        return {tuple(v) for v in np.round(c, 1).tolist()}

    ca, cb = centroids(a), centroids(b)
    assert len(ca & cb) / max(1, len(ca | cb)) > 0.95


@pytest.mark.parametrize("gather", [False, True])
def test_device_backends_meet_oracle_tolerances(gather):
    """The kernel backend's plain versions and the gather backend on the CPU
    against the port's NumPy oracle, the first frame of the motion case."""
    cfg, xs = two_cubes(tscene)
    res, got = ts.TorchSolver(h=cfg.h, gather=gather, device="cpu").advance(
        tscene.apply_motion_sin_x_cos_z(cfg, 0), ttypes.Scene(), xs)
    want_res, want = run(NumpySolver, "float32", "motion", "port")[0]
    assert_state_close(got.order_by_id(), want.order_by_id())
    assert_mesh_close(res.mesh, want_res.mesh)


@pytest.mark.parametrize("impl", ["numpy", "cpp"])
def test_oracle_takes_no_device(impl, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for device in ("cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(ValueError, match="takes no device"):
            make_solver(impl, device=device)
    for kwargs in ({}, {"device": "cpu"}, {"device": None}):
        solver = make_solver(impl, dtype="float64", **kwargs)
        assert isinstance(solver, ORACLES[impl][0]) and np.dtype(solver.dtype) == np.float64


def _files(out, n: int, verts: int) -> None:
    ply = (out / "cloud.ply").read_text().splitlines()
    obj = (out / "mesh.obj").read_text().splitlines()
    assert f"element vertex {n}" in ply and len(ply) - ply.index("end_header") - 1 == n
    assert sum(1 for line in obj if line.startswith("v ")) == verts > 0


@pytest.mark.parametrize("impl,extra", [("numpy", []), ("cpp", []),
                                        ("cpp", ["--fp64", "--phase-timings"])])
def test_cli_runs_the_oracles_without_a_card(impl, extra, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--impl", impl, *extra, "--count", "700", "--warmup", "1", "--iter", "2",
            "--output", str(tmp_path / "out_{impl}_{type}_{iter}")]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    stats = {line.split(":")[0].strip(): line.split(":", 1)[1].strip()
             for line in out.splitlines() if " : " in line}
    n, verts = int(stats["Final Particle count"]), int(stats["Final Vertex count"])
    assert n == len(two_cubes(tscene)[1]) and "Results flushed." in out
    assert "Using device" not in out
    fp64 = "--fp64" in extra
    _files(tmp_path / f"out_{impl}_{'double' if fp64 else 'float'}_2", n, verts)
    if "--phase-timings" in extra:
        assert out.count("Stopwatch[ advance]") == 2 and all(f"`{p}`" in out for p in PHASES)


@pytest.mark.parametrize("impl", ["cpp", "numpy"])
def test_cli_multichip_refuses_an_oracle(impl, capsys):
    assert cli.main(["--impl", impl, "--multichip", "2", "--count", "700"]) == 1
    assert "--multichip requires --impl torch or gather" in capsys.readouterr().err


def test_visualise_cpp_matches_jax(tmp_path, monkeypatch):
    """The loop through the C++ oracle, on the host without a card: the
    JAX loop's files byte for byte."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--impl", "cpp", "--particles", "700", "--frames", "2", "--checkpoint-every", "1"]
    assert visualise.main(argv + ["--out", str(tmp_path / "port")]) == 0
    assert jvis.main(argv + ["--out", str(tmp_path / "jax")]) == 0
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert "mesh_00001.obj" in names and "ckpt_00001.npz" in names
    for name in names:
        if name.endswith(".npz"):
            a, b = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
            assert all(np.array_equal(a[k], b[k]) for k in b.files)
        else:
            assert (tmp_path / "port" / name).read_bytes() == \
                (tmp_path / "jax" / name).read_bytes(), name


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cpp_oracle_repeats_bit_for_bit(dtype):
    """One frame twice in one process, each through a new solver: the same
    bits, mesh included (no reduction and no atomic feeds an output)."""
    cfg, xs = two_cubes(tscene)
    (ra, a), (rb, b) = (CppSolver(h=cfg.h, dtype=dtype).advance(cfg, ttypes.Scene(), xs)
                        for _ in range(2))
    assert len(ra.mesh.vs) > 0 and a.position.dtype == np.dtype(dtype)
    for k in FIELDS:
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    for k in ("vs", "ns", "cs"):
        assert np.array_equal(getattr(ra.mesh, k), getattr(rb.mesh, k), equal_nan=True), k


def test_library_name_follows_the_host_cpu(monkeypatch):
    """`-march=native` builds for the host, so a library built on another
    CPU is never loaded: the host CPU is part of the name's hash."""
    header = build.tables_header()
    here = build.library_path(header)
    assert "flags" in build.host_cpu() and here.parent == build.BUILD
    monkeypatch.setattr(build, "host_cpu", lambda: "another CPU")
    assert build.library_path(header) != here
