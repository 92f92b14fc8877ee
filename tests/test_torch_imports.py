"""The port stands alone: no jax, no JAX package, no hidden device choice."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pbf_sph_tpu_torch.core.configs import dam_break
from pbf_sph_tpu_torch.core.types import Scene
from pbf_sph_tpu_torch.models import make_solver
from pbf_sph_tpu_torch.models.torch_solver import TorchSolver, dyn_params_of
from pbf_sph_tpu_torch.ops import mc_field as mf
from pbf_sph_tpu_torch.ops import phases as ph
from pbf_sph_tpu_torch.ops import tiles as tl

REPO = Path(__file__).resolve().parent.parent

IMPORT_ALL = """
import importlib, pkgutil, sys
import pbf_sph_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pbf_sph_tpu_torch.__path__, "pbf_sph_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pbf_sph_tpu"))
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 24  # every module of the package


def test_cuda_solver_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSolver(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_solver("torch", device="cuda")


def test_default_device_is_cuda(monkeypatch):
    """Without a device the solver asks for CUDA, and without a card it
    raises; it never picks the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSolver()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_solver("torch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert TorchSolver().device == torch.device("cuda")


def test_cpu_run_launches_no_kernel():
    mc, cfg, xs = dam_break(2000, solver_iter=2)
    solver = TorchSolver(h=cfg.h, device="cpu")
    _, out = solver.advance(cfg, Scene(), xs)
    assert len(out) == len(xs)
    assert solver.phases.launches == {"diffuse": 0, "lambda": 0, "delta": 0}


def test_kernel_launchers_refuse_cpu_tensors():
    """A launcher never falls back to the plain version."""
    mc, cfg, xs = dam_break(2000, solver_iter=2, surface=True)
    solver = TorchSolver(h=cfg.h, device="cpu")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    index = ph.CellIndex(spec.grid, torch.zeros(spec.capacity, dtype=torch.int32),
                         torch.zeros(spec.grid.ncells + 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ph.lambda_kernel(index, spec.h, state.position, state.mass)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ph.delta_kernel(index, spec.h, state.position, state.mass)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ph.diffuse_kernel(index, state.colour, state.mass)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mf.mc_field_kernel(index, spec.surface, spec.h, spec.scale, state.position,
                           state.colour, state.mass, torch.zeros(3))


def test_tile_launchers_refuse_cpu_tensors():
    """The tiled launchers never fall back to their plain versions either."""
    mc, cfg, xs = dam_break(2000, solver_iter=2)
    solver = TorchSolver(h=cfg.h, device="cpu")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    index = ph.CellIndex(spec.grid, torch.zeros(spec.capacity, dtype=torch.int32),
                         torch.zeros(spec.grid.ncells + 1, dtype=torch.int32))
    tiles = tl.plan_tiles(index, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tl.lambda_tile_kernel(tiles, index, spec.h, state.position, state.mass, 32, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tl.delta_tile_kernel(tiles, index, spec.h, state.position, state.mass, 32, False)


def test_surface_steps_on_cpu_without_launches():
    mc, cfg, xs = dam_break(4096, solver_iter=2, surface=True)
    solver = TorchSolver(h=cfg.h, device="cpu")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    assert spec.surface is not None
    _, out = solver.step_device(spec, state, dyn_params_of(cfg, device="cpu"), scn)
    assert out["mesh_vs"].shape == (3, 3 * spec.surface.tri_capacity)
    assert 0 < int(out["tri_count"]) <= spec.surface.tri_capacity
    assert int(out["mc_emit_overflow"]) == int(out["mc_strip_overflow"]) == 0
    res, _ = solver.advance(cfg, Scene(), xs)
    assert len(res.mesh) > 0 and len(res.mesh) % 3 == 0
    assert solver.launches == {"diffuse": 0, "lambda": 0, "delta": 0, "mc_field": 0}
