"""The port's frame with its marching-cubes surface against the JAX package's
XLA frame, on CPU.

`TorchSolver(device="cpu").advance` runs the plain PyTorch versions of the
kernels; `JaxSolver(use_pallas=False).advance` is the reference.  Particles
as in `test_torch_step.py`; the triangle count exact, and with it the
vertex order; vertices atol 1e-2 world units (the field sums in another fp
order, and the XLA field measures with sqrt where the port's uses rsqrt),
normals and colours atol 1e-3.  The XLA field clamps its stencil at the
grid edge where the port's takes the exact 27 cells, and gives NaN on the
far-corner node where the port gives 0; both lie in the padding band the
bounds clamp keeps empty, so the meshes agree.
"""

import numpy as np
import pytest

import pbf_sph_tpu.core.types as jtypes
from pbf_sph_tpu.core.configs import dam_break as jax_dam_break
from pbf_sph_tpu.core.scene import simple_config_with_2_cubes as jax_2cubes
from pbf_sph_tpu.models.jax_solver import JaxSolver
from pbf_sph_tpu_torch.core import types as ttypes
from pbf_sph_tpu_torch.models.torch_solver import TorchSolver
from test_torch_step import _close, _to_port


def _with_surface(tup):
    mc, cfg, xs = tup
    return mc, cfg.replace(surface=mc), xs


# name -> (scene, position atol)
SCENES = {
    # res 2.0; 1544 triangles.  Over-compressed at 1500 particles: the phases'
    # rsqrt against the XLA path's sqrt moves one coordinate by 1.04e-3 in
    # this frame (test_torch_step.py keeps the 700-particle scene at 1e-3)
    "2cubes1500": (lambda: _with_surface(jax_2cubes(1500, 2, 500.0)), 2e-3),
    # res 1.0, the mc128k geometry at a small count; 128 triangles
    "dam4096": (lambda: jax_dam_break(4096, solver_iter=2, surface=True), 1e-3),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_surface_advance_matches_jax(name):
    scene, pos_atol = SCENES[name]
    mc, cfg, xs = scene()
    jres, want = JaxSolver(h=cfg.h).advance(cfg, jtypes.Scene(), xs)
    tres, got = TorchSolver(h=cfg.h, device="cpu").advance(cfg, ttypes.Scene(), _to_port(xs))
    assert len(got) == len(xs)
    _close(got, want, pos_atol)

    jm, tm = jres.mesh, tres.mesh
    assert len(jm) > 0 and len(jm) % 3 == 0
    assert len(tm) == len(jm)
    np.testing.assert_allclose(tm.vs, jm.vs, atol=1e-2, rtol=0)
    np.testing.assert_allclose(tm.ns, jm.ns, atol=1e-3, rtol=0)
    np.testing.assert_allclose(tm.cs, jm.cs, atol=1e-3, rtol=0)
