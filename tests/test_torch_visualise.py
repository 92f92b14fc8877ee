"""The port's visualise loop against the JAX package's, on CPU.

* The loop with no physics: `make_solver` in both `visualise` modules is a
  recording stub in each package's own types, whose `advance` moves the
  positions by a seeded step and returns a small seeded mesh.  Over a matrix
  of argv (the scheduled `--set`s with their surface off and on, export and
  checkpoint cadences, `--no-surface`, `--no-motion`, `--workload dam`,
  `--resume` from a checkpoint the JAX package wrote, `--render` with
  `--turntable`) both loops give the same (frame, config, particle count)
  sequence, the same files (PLY, OBJ and PNG byte for byte, checkpoints
  array for array) and the same `frame ...` lines.
* `parse_live_sets`, `apply_live_set` and `precompile_plan` equal the JAX
  functions field by field; `--precompile` changes nothing; the `--live`
  stdin loop prints `set`, `reset` and `quit` and ends the run early, as the
  JAX test of it (`tests/test_cli.py::test_visualise_live_stdin_loop`)
  holds; without a card and without `--devices cpu` the loop exits with the
  CLI's "No CUDA device" message.
* The slice as a whole: `--impl torch --devices cpu` (the kernels' plain
  versions) against the JAX package's `--impl jax` on the dam break at 4096
  particles, res 1.0, 2 frames (`test_torch_surface.py`'s dam4096 frame):
  frame 0 to that file's tolerances, frame 1 with the particle count exact,
  positions to atol 2e-3 and triangle counts within 1%.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

import pbf_sph_tpu.core.types as jtypes
from pbf_sph_tpu import visualise as jvis
from pbf_sph_tpu.core.scene import simple_config_with_2_cubes as jax_2cubes
from pbf_sph_tpu.utils import export as jexport
from pbf_sph_tpu_torch import visualise as tvis
from pbf_sph_tpu_torch.core import types as ttypes
from pbf_sph_tpu_torch.core.scene import simple_config_with_2_cubes
from test_torch_step import _close, _to_port

MODULES = {"jax": (jvis, jtypes), "port": (tvis, ttypes)}
# the scheduled changes of chip_smoke.py's phase 8a, with scale and dt
SETS = ["6:iteration=1", "10:mc_resolution=1.0", "14:surface=0", "18:surface=1",
        "20:force=0,12,0", "3:scale=400", "5:dt=0.01", "8:mc_isolevel=90"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests (see test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StubSolver:
    """`advance` without physics, in one package's types: records (config,
    particle count), moves the positions by a step seeded by the call's
    index, and returns a seeded 6-triangle mesh while the surface is on."""

    def __init__(self, types):
        self.types = types
        self.calls = []

    def advance(self, config, scene, xs):
        k = len(self.calls)
        self.calls.append((dataclasses.asdict(config), len(xs)))
        rng = np.random.default_rng(k)
        step = rng.normal(0.0, 2.0, xs.position.shape).astype(xs.position.dtype)
        xs = dataclasses.replace(xs, position=xs.position + step)
        mesh = self.types.ColouredMesh.empty()
        if config.surface is not None:
            vs = rng.uniform(300.0, 700.0, (18, 3)).astype(np.float32)
            mesh = self.types.ColouredMesh(
                vs, rng.normal(size=(18, 3)).astype(np.float32),
                rng.uniform(0.0, 1.0, (18, 4)).astype(np.float32))
        return self.types.Result(mesh=mesh), xs


def _run_stubbed(pkg, argv, out, monkeypatch, capsys):
    """One package's `main(argv)` over a StubSolver: (calls with their
    frames, file name -> contents, `frame ...` lines)."""
    mod, types = MODULES[pkg]
    stub = StubSolver(types)
    monkeypatch.setattr(mod, "make_solver", lambda *a, **k: stub)
    extra = ["--devices", "cpu"] if pkg == "port" else []
    assert mod.main([*argv, *extra, "--out", str(out)]) == 0
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("frame ")]
    frames = [int(line.split()[1][:-1]) for line in lines if "particles=" in line]
    files = {}
    for f in sorted(out.iterdir()):
        if f.suffix == ".npz":
            with np.load(f) as d:
                files[f.name] = {k: d[k] for k in d.files}
        else:
            files[f.name] = f.read_bytes()
    return list(zip(frames, stub.calls)), files, lines


def _jax_checkpoint(path):
    """A checkpoint the JAX package wrote after frame 7: the 2-cube scene of
    300 particles, moved."""
    _, _, xs = jax_2cubes(300, 3, 500.0)
    xs = dataclasses.replace(xs, position=xs.position + np.float32(3.5))
    jexport.save_checkpoint(path, xs, 7)


# case -> argv (each case's --out is its own)
LOOPS = {
    "sets_render": ["--particles", "300", "--frames", "22", "--every", "4",
                    "--checkpoint-every", "8", "--render", "--render-size", "64x48",
                    "--turntable", "2", *(a for s in SETS for a in ("--set", s))],
    "every3_ckpt2": ["--particles", "300", "--frames", "7", "--every", "3",
                     "--checkpoint-every", "2"],
    "no_surface": ["--particles", "300", "--frames", "3", "--no-surface",
                   "--set", "1:surface=1", "--set", "2:mc_resolution=1.0"],
    "no_motion": ["--particles", "300", "--frames", "3", "--no-motion", "--dt-scale", "0.5",
                  "--solver-iter", "2", "--mc-particle-influence", "0.25"],
    "dam": ["--workload", "dam", "--particles", "500", "--frames", "3",
            "--render", "--render-size", "64x48", "--render-no-cloud"],
    "resume_jax_ckpt": ["--particles", "300", "--frames", "3", "--set", "8:iteration=2",
                        "--checkpoint-every", "1", "--resume", "RESUME"],
}


@pytest.mark.parametrize("case", sorted(LOOPS))
def test_loop_matches_jax(case, tmp_path, monkeypatch, capsys):
    argv = list(LOOPS[case])
    if "RESUME" in argv:
        _jax_checkpoint(tmp_path / "ckpt_00007.npz")
        argv[argv.index("RESUME")] = str(tmp_path / "ckpt_00007.npz")
    calls, files, lines = _run_stubbed("port", argv, tmp_path / "port", monkeypatch, capsys)
    want_calls, want_files, want_lines = _run_stubbed("jax", argv, tmp_path / "jax",
                                                      monkeypatch, capsys)
    assert calls == want_calls and len(calls) == int(argv[argv.index("--frames") + 1])
    assert lines == want_lines
    assert sorted(files) == sorted(want_files)
    for name, got in files.items():
        if name.endswith(".npz"):
            assert got.keys() == want_files[name].keys()
            for k in got:
                np.testing.assert_array_equal(got[k], want_files[name][k])
        else:
            assert got == want_files[name], name
    if case == "sets_render":
        assert [c["iteration"] for _, (c, _) in calls[5:7]] == [3, 1]
        assert calls[14][1][0]["surface"] is None and calls[18][1][0]["surface"] == \
            dataclasses.asdict(ttypes.McParams())
        assert {"mesh_00016.obj", "frame_00016.png", "turntable_01.png"} & set(files) == \
            {"frame_00016.png", "turntable_01.png"}
    if case == "resume_jax_ckpt":
        assert calls[0][0] == 8 and calls[0][1][0]["iteration"] == 2


def test_precompile_does_nothing(tmp_path, monkeypatch, capsys):
    argv = ["--particles", "300", "--frames", "4", "--set", "1:iteration=1",
            "--set", "2:mc_resolution=1.0"]
    plain = _run_stubbed("port", argv, tmp_path / "a", monkeypatch, capsys)
    pre = _run_stubbed("port", [*argv, "--precompile", "--precompile-ladder", "2"],
                       tmp_path / "b", monkeypatch, capsys)
    assert pre == plain


def test_live_helpers_match_jax():
    sets = [*SETS, "6:scale=450", "0:surface=off"]
    assert tvis.parse_live_sets(sets) == jvis.parse_live_sets(sets)
    for mod in (tvis, jvis):
        with pytest.raises(SystemExit, match="FRAME:key=value"):
            mod.parse_live_sets(["x:iteration=2"])
        with pytest.raises(SystemExit, match="unknown live parameter"):
            mod.apply_live_set(jax_2cubes(300, 3, 500.0)[1], "bogus", "1")

    mc, config, _ = simple_config_with_2_cubes(300, 3, 500.0)
    jmc, jconfig, _ = jax_2cubes(300, 3, 500.0)
    for port_cfg, jax_cfg in ((config, jconfig),
                              (config.replace(surface=mc), jconfig.replace(surface=jmc))):
        for key, val in (("iteration", "2"), ("dt", "0.02"), ("scale", "400"),
                         ("force", "0,12,0"), ("surface", "0"), ("surface", "1"),
                         ("surface", "off"), ("mc_resolution", "1.0"),
                         ("mc_isolevel", "90"), ("mc_particle_size", "20"),
                         ("mc_particle_influence", "0.25")):
            got = tvis.apply_live_set(port_cfg, key, val)
            assert dataclasses.asdict(got) == dataclasses.asdict(
                jvis.apply_live_set(jax_cfg, key, val)), (key, val)
        for ladder in (0, 2):
            got = tvis.precompile_plan(port_cfg, tvis.parse_live_sets(SETS), ladder)
            want = jvis.precompile_plan(jax_cfg, jvis.parse_live_sets(SETS), ladder)
            assert [dataclasses.asdict(c) for c in got] == [dataclasses.asdict(c) for c in want]
            assert len(got) > 2


def test_live_stdin_loop(tmp_path, capsys, monkeypatch):
    """--live: key=value lines from stdin change the next frame; 'reset'
    restores the initial parameters; 'quit' ends the run early."""
    monkeypatch.setattr("sys.stdin", io.StringIO("iteration=2\nbogus_line\nreset\nquit\n"))
    rc = tvis.main(["--devices", "cpu", "--particles", "300", "--frames", "50",
                    "--no-surface", "--live", "--out", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "set iteration=2" in out
    assert "ignored 'bogus_line'" in out
    assert "reset" in out
    assert "quit" in out
    # ended early: far fewer than 50 frames ran
    assert out.count("particles=") < 10


def test_no_card_no_cpu_fallback(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="No CUDA device"):
        tvis.main(["--particles", "300", "--frames", "1", "--out", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


class Keeping:
    """A real solver whose `advance` keeps each frame's (config, result, xs)."""

    def __init__(self, solver):
        self.solver, self.frames = solver, []

    def advance(self, config, scene, xs):
        result, xs = self.solver.advance(config, scene, xs)
        self.frames.append((config, result, xs))
        return result, xs


def test_slice_matches_jax_dam4096(tmp_path, monkeypatch, capsys):
    argv = ["--workload", "dam", "--particles", "4096", "--solver-iter", "2",
            "--mc-resolution", "1.0", "--frames", "2"]
    kept = {}
    for pkg, impl in (("port", ["--impl", "torch", "--devices", "cpu"]),
                      ("jax", ["--impl", "jax"])):
        mod = MODULES[pkg][0]
        make = mod.make_solver
        monkeypatch.setattr(mod, "make_solver", lambda *a, _m=make, _p=pkg, **k:
                            kept.setdefault(_p, Keeping(_m(*a, **k))))
        assert mod.main([*argv, *impl, "--out", str(tmp_path / pkg)]) == 0
    assert "Using device: cpu" in capsys.readouterr().out
    port = kept["port"]
    assert port.solver.device == torch.device("cpu") and not port.solver.gather
    (_, r0, x0), (cfg1, r1, x1) = port.frames
    (_, j0, w0), (_, j1, w1) = kept["jax"].frames
    assert len(x0) == len(w0) == len(x1) == len(w1) > 4000

    _close(x0, w0, 1e-3)
    assert len(r0.mesh) == len(j0.mesh) > 0
    np.testing.assert_allclose(r0.mesh.vs, j0.mesh.vs, atol=1e-2, rtol=0)
    np.testing.assert_allclose(r0.mesh.ns, j0.mesh.ns, atol=1e-3, rtol=0)
    np.testing.assert_allclose(r0.mesh.cs, j0.mesh.cs, atol=1e-3, rtol=0)

    a, b = x1.order_by_id(), w1.order_by_id()
    np.testing.assert_array_equal(a.pid, b.pid)
    # frame 1 of each loop's own chain: frame 0's differences (under 1e-3)
    # carried through a frame of the layer that the moved wall compresses
    # (the motion's frame-0 bounds start at z = 90, past ~400 particles of
    # the column) grow to 6.2e-3 on 59 of the 13662 coordinates; the gather
    # backend, which keeps the XLA path's op order, reads the same 6.2e-3
    np.testing.assert_allclose(a.position, b.position, atol=1e-2, rtol=0)
    # the port's frame 1 from the JAX frame 0's state: 2e-3
    _, alone = port.solver.advance(cfg1, ttypes.Scene(), _to_port(w0))
    _close(alone, w1, 2e-3)
    t, want = len(r1.mesh) // 3, len(j1.mesh) // 3
    assert want > 0 and abs(t - want) <= 0.01 * want
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())
