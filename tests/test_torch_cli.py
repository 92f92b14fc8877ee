"""The port's benchmark CLI, Stopwatch and export against the JAX package's,
on CPU.

* `rendered_output_name` and `summary_stats` equal the JAX CLI's;
* the port's `Stopwatch.__str__` and `export.save` files equal the JAX
  `utils` ones byte for byte on the same arrays;
* `main(["--devices", "cpu", "--impl", "gather", ...])` returns 0, prints the
  JAX CLI's stats labels in its order (`pbf_sph_tpu/cli.py:718-728`) and
  writes the files of the same frames driven by hand through
  `TorchSolver(gather=True, device="cpu").advance`;
* `--impl torch --fp64` returns 1 with the reference's message, an unmatched
  `--devices` exits, the CLI fails without a card unless `--devices cpu`,
  and `--phase-timings` prints one stage table per timed frame.
"""

import numpy as np
import pytest
import torch

import pbf_sph_tpu.core.types as jtypes
from pbf_sph_tpu import cli as jcli
from pbf_sph_tpu.utils import export as jexport
from pbf_sph_tpu.utils.stopwatch import Stopwatch as JStopwatch
from pbf_sph_tpu_torch import cli
from pbf_sph_tpu_torch.core import types as ttypes
from pbf_sph_tpu_torch.core.scene import apply_motion_sin_x_cos_z, simple_config_with_2_cubes
from pbf_sph_tpu_torch.models.torch_solver import TorchSolver
from pbf_sph_tpu_torch.utils import export
from pbf_sph_tpu_torch.utils.stopwatch import Stopwatch

LABELS = ["Benchmark completed after", "Runtime", "Framerate", "Frame-time min",
          "Frame-time max", "Frame-time mean", "Frame-time stdDev",
          "Final Vertex count", "Final Particle count", "Results flushed."]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests: their eager torch ops
    are many and small, and the tier runs several test processes at once,
    where a pool of a thread a core each oversubscribes the cores and made
    these tests ~10-25x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("template", ["./out_{impl}_{type}_{iter}", "{impl}/{impl}-{iter}", "x"])
@pytest.mark.parametrize("fp64", [False, True])
def test_output_name_and_stats_match_jax(template, fp64):
    assert (cli.rendered_output_name(template, "gather", fp64, 7)
            == jcli.rendered_output_name(template, "gather", fp64, 7))
    times = np.random.default_rng(3).uniform(1.0, 9.0, 17).tolist()
    np.testing.assert_array_equal(cli.summary_stats(times), jcli.summary_stats(times))


def test_stopwatch_matches_jax():
    entries = [("sources+drains", 0.25), ("mc field", 12.5), ("idle before frame", 0.0031)]
    assert (str(Stopwatch.from_durations("advance", entries))
            == str(JStopwatch.from_durations("advance", entries)))
    assert str(Stopwatch("empty")) == str(JStopwatch("empty"))


def _soa(mod, n, rng, dtype):
    return mod.ParticleSoA(
        pid=np.arange(n, dtype=np.int32), ptype=np.zeros(n, np.int32),
        mass=np.ones(n, dtype), position=rng.normal(0, 300, (n, 3)).astype(dtype),
        velocity=rng.normal(size=(n, 3)).astype(dtype),
        colour=rng.uniform(-0.1, 1.1, (n, 4)).astype(dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_export_bytes_match_jax(tmp_path, dtype):
    rng = np.random.default_rng(11)
    mesh = [rng.normal(size=(12, k)).astype(dtype) for k in (3, 3, 4)]
    for name, mod, save in (("port", ttypes, export.save), ("jax", jtypes, jexport.save)):
        save(mod.Result(mesh=mod.ColouredMesh(*mesh)), _soa(mod, 50, np.random.default_rng(5),
                                                            dtype), tmp_path / name)
    for f in ("cloud.ply", "mesh.obj"):
        got = (tmp_path / "port" / f).read_bytes()
        assert got == (tmp_path / "jax" / f).read_bytes() and len(got) > 200


def _stats(out: str):
    lines = out.splitlines()
    at = [next(i for i, line in enumerate(lines) if line.startswith(label))
          for label in LABELS]
    assert at == sorted(at)
    return {line.split(":")[0].strip(): line.split(":", 1)[1].strip()
            for line in lines if " : " in line}


def test_main_gather_on_cpu_matches_frames_by_hand(tmp_path, capsys):
    out = tmp_path / "o_{impl}_{type}_{iter}"
    assert cli.main(["--devices", "cpu", "--impl", "gather", "--count", "700",
                     "--warmup", "1", "--iter", "2", "--output", str(out)]) == 0
    stats = _stats(capsys.readouterr().out)
    assert int(stats["Final Particle count"]) == 686
    assert int(stats["Final Vertex count"]) > 0
    written = tmp_path / "o_gather_float_2"

    mc, cfg, xs = simple_config_with_2_cubes(700, 6, 500.0)
    cfg = cfg.replace(surface=mc)
    solver = TorchSolver(h=cfg.h, gather=True, device="cpu")
    for frame in (0, 0, 1):  # warmup frame 0, then the timed frames from 0
        res, xs = solver.advance(apply_motion_sin_x_cos_z(cfg, frame), ttypes.Scene(), xs)
    assert len(res.mesh) == int(stats["Final Vertex count"])
    export.save(res, xs, tmp_path / "by_hand")
    for f in ("cloud.ply", "mesh.obj"):
        assert (written / f).read_bytes() == (tmp_path / "by_hand" / f).read_bytes()


def test_main_phase_timings_one_table_a_frame(tmp_path, capsys):
    assert cli.main(["--devices", "cpu", "--impl", "gather", "--count", "700",
                     "--no-surface", "--warmup", "0", "--iter", "2", "--phase-timings",
                     "--output", str(tmp_path / "o")]) == 0
    out = capsys.readouterr().out
    assert out.count("Stopwatch[ advance, host ms by stage (host clock)]:") == 2
    for stage in ("sort+gather", "diffuse", "lambda", "delta", "finalise"):
        assert out.count(f"->`{stage}`") == 2
    _stats(out)


def test_main_refuses_fp64_on_torch(capsys):
    assert cli.main(["--impl", "torch", "--fp64", "--devices", "cpu"]) == 1
    assert "FP64 is not supported for the torch backend!" in capsys.readouterr().err


def test_main_device_choice(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="No device matched"):
        cli.main(["--devices", "H100", "--count", "700", "--iter", "1", "--warmup", "0"])
    with pytest.raises(SystemExit, match="No CUDA device"):
        cli.main(["--impl", "gather", "--count", "700", "--iter", "1", "--warmup", "0"])
    assert cli.find_device(["CPU"]) == torch.device("cpu")
    assert cli.main(["--list"]) == 0
    assert "no CUDA device" in capsys.readouterr().out
