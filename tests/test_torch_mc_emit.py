"""The port's blocked two-stage MC emission (`McSpec.emit_block`/`emit_cap`,
`pbf_sph_tpu_torch/ops/mc.py`) and its growth branch
(`pbf_sph_tpu_torch/models/growth.py`) against the JAX package.

The counterparts of `tests/test_mc_emit.py:48-95,143-160`, on its analytic
metaball lattice (17³ nodes, 752 triangles):

* at B = 64, 512 and 4096 (B not dividing M, and B = M) with a staging cap
  that cannot overflow, the blocked mesh equals the port's one-stage
  scatter and JAX's `mc_extract` with `emit_block` set, bit for bit (the
  JAX test's own tolerance: `assert_array_equal`), with the same triangle
  count;
* `emit_overflow` equals JAX's exactly at every (B, emit_cap) of a grid
  that overflows and does not, and so does the overflow that
  `tools/micro_extract.py`'s per-block live-row census implies;
* `growth_changes` gives JAX's surface changes for the same outputs: the
  emit_cap growth, the fall-back to emit_block = 0, the default cap, and
  the cube_cap branch taken first;
* `TorchSolver.advance` on the CPU with emit_block 1024 and emit_cap 128
  overflows on its first attempt, grows, and ends with the mesh of the
  emit_block = 0 solver bit for bit (the JAX case is `slow`: its surface
  frame compiles for ~30 s; the port's runs in ~4 s).  The JAX case runs
  dam_break(400), whose first frame crosses the isolevel nowhere; this one
  runs the 2-cube scene of the dry run at 1500 particles (lattice
  resolution 1.0, 392 triangles, 118 rows over the cap).

torch runs on one intra-op thread in this module.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbf_sph_tpu.core.configs import dam_break as jax_dam_break
from pbf_sph_tpu.core.types import Scene as JaxScene
from pbf_sph_tpu.models.growth import growth_changes as jax_growth_changes
from pbf_sph_tpu.models.jax_solver import JaxSolver
from pbf_sph_tpu.ops import mc as jmc
from pbf_sph_tpu_torch.core.configs import dam_break
from pbf_sph_tpu_torch.core.scene import simple_config_with_2_cubes
from pbf_sph_tpu_torch.core.types import Scene
from pbf_sph_tpu_torch.models.growth import growth_changes
from pbf_sph_tpu_torch.models.torch_solver import TorchSolver, dyn_params_of
from pbf_sph_tpu_torch.ops import mc as tmc
from pbf_sph_tpu_torch.tools import micro_extract

N = 17
ISO = 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the tier runs several test
    processes at once, and torch's default pool in each of them
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sphere_lattice(n=N):
    """`tests/test_mc_emit.py`'s metaball lattice: (v (L,), normals (3, L),
    colours (4, L)) float32."""
    g = np.arange(n, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    c = (n - 1) / 2.0
    r = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) + 1e-3
    v = (c * 0.7 / r).astype(np.float32).reshape(-1)
    nvec = np.stack([x - c, y - c, z - c]).reshape(3, -1).astype(np.float32)
    nvec = nvec / (np.sqrt((nvec ** 2).sum(0)) + 1e-6)
    col = np.stack([
        0.5 + 0.5 * np.sin(x).reshape(-1),
        0.5 + 0.5 * np.cos(y).reshape(-1),
        0.5 + 0.5 * np.sin(z + 1).reshape(-1),
        np.ones(n ** 3, np.float32),
    ]).astype(np.float32)
    return v, nvec, col


LATTICE = sphere_lattice()


def port(emit_block=0, emit_cap=0):
    spec = tmc.McSpec(resolution=1.0, sample=(N, N, N), tri_capacity=8192,
                      emit_block=emit_block, emit_cap=emit_cap)
    v, n, c = (torch.from_numpy(a.copy()) for a in LATTICE)
    out = tmc.mc_extract(v, n, c, torch.zeros(3), spec, 1.0, torch.tensor(1.0),
                         torch.tensor(ISO))
    return [t.numpy() for t in out[:3]], int(out[3]), int(out[4])


def jax(emit_block=0, emit_cap=0):
    spec = jmc.McSpec(resolution=1.0, sample=(N, N, N), tri_capacity=8192,
                      emit_block=emit_block, emit_cap=emit_cap)
    v, n, c = (jnp.asarray(a) for a in LATTICE)
    out = jmc.mc_extract(v, n, c, jnp.zeros((3,), jnp.float32), (N - 1,) * 3, spec, 1.0,
                         jnp.float32(1.0), jnp.float32(ISO))
    return [np.asarray(t) for t in out[:3]], int(out[3]), int(out[4])


def no_overflow_cap():
    """A staging cap no block can pass: every block's live rows <= 3 * total."""
    return -(-3 * port()[1] // 128) * 128


@pytest.mark.parametrize("block", [64, 512, 4096])
def test_blocked_emission_matches_scatter_and_jax(block):
    (vs, ns, cs), total, ovf = port()
    assert total > 100 and ovf == 0
    cap = no_overflow_cap()
    got, gtotal, govf = port(block, cap)
    want, wtotal, wovf = jax(block, cap)
    assert gtotal == wtotal == total and govf == wovf == 0
    for g, s, w in zip(got, (vs, ns, cs), want):
        np.testing.assert_array_equal(g, s)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("block,cap", [(64, 128), (512, 384), (4096, 1280), (4096, 2304),
                                       (1000, 0)])
def test_emit_overflow_matches_jax(block, cap):
    _, gtotal, govf = port(block, cap)
    _, wtotal, wovf = jax(block, cap)
    assert gtotal == wtotal
    assert govf == wovf
    # micro_extract's per-block census gives the same overflow from the
    # per-cube triangle counts
    spec = tmc.McSpec(resolution=1.0, sample=(N, N, N), tri_capacity=8192)
    v, n, c = (torch.from_numpy(a.copy()) for a in LATTICE)
    ntris = tmc.emission_inputs(v, n, c, torch.zeros(3), spec, 1.0, torch.tensor(1.0),
                                torch.tensor(ISO))[0].numpy()
    _, live = micro_extract.block_census(ntris, [block])[block]
    assert max(int(live.max()) - max(128, cap or tmc.EMIT_CAP_DEFAULT), 0) == wovf
    # the grid reaches both sides of the staging cap
    assert (govf > 0) == ((block, cap) in {(64, 128), (512, 384), (4096, 1280)})


def _specs(**surface):
    """The port's and the JAX package's StepSpec of dam_break(400) with the
    surface fields replaced."""
    _, tcfg, _ = dam_break(400, solver_iter=1, surface=True)
    _, jcfg, _ = jax_dam_break(400, solver_iter=1, surface=True)
    ts = TorchSolver(h=tcfg.h, device="cpu").make_spec(tcfg, Scene(), capacity=512)
    js = JaxSolver(h=jcfg.h).make_spec(jcfg, JaxScene(), capacity=512)
    return (dataclasses.replace(ts, surface=dataclasses.replace(ts.surface, **surface)),
            dataclasses.replace(js, surface=dataclasses.replace(js.surface, **surface)))


@pytest.mark.parametrize("surface,eovf", [
    (dict(emit_block=512, emit_cap=1280), 100),        # grows
    (dict(emit_block=512, emit_cap=1280), 15 * 512),   # falls back to emit_block 0
    (dict(emit_block=1024, emit_cap=0), 37),           # from EMIT_CAP_DEFAULT
    (dict(emit_block=1024, emit_cap=128), 900),        # the advance case's first step
    (dict(emit_block=64, emit_cap=128), 58),           # cap + growth >= 15 * B
    (dict(emit_block=512, emit_cap=1280, cube_cap=128), 300),  # cube_cap first
    (dict(emit_block=512, emit_cap=1280), 0),          # nothing overflowed
])
def test_growth_changes_match_jax(surface, eovf):
    tspec, jspec = _specs(**surface)
    out = dict(max_occupancy=0, tri_count=0, mc_emit_overflow=eovf)
    got, want = growth_changes(tspec, out), jax_growth_changes(jspec, out)
    assert set(got) == set(want)
    if "surface" in want:
        for f in ("emit_block", "emit_cap", "cube_cap", "tri_capacity"):
            assert getattr(got["surface"], f) == getattr(want["surface"], f), f
    assert tmc.EMIT_CAP_DEFAULT == jmc.EMIT_CAP_DEFAULT


class TinyEmit(TorchSolver):
    def make_spec(self, *a, **kw):
        spec = super().make_spec(*a, **kw)
        return dataclasses.replace(spec, surface=dataclasses.replace(
            spec.surface, emit_block=1024, emit_cap=128))


def test_advance_grows_to_the_one_stage_mesh():
    mc, cfg, xs = simple_config_with_2_cubes(1500, 2, 500.0)
    cfg = cfg.replace(surface=dataclasses.replace(mc, resolution=1.0))
    ref = TorchSolver(h=cfg.h, device="cpu")
    tiny = TinyEmit(h=cfg.h, device="cpu")
    spec, state, scn = tiny.prepare(cfg, Scene(), xs)
    assert spec.surface.cube_cap == 0  # the blocked branch is taken
    _, out = tiny.step_device(spec, state, dyn_params_of(cfg, device="cpu"), scn)
    assert int(out["mc_emit_overflow"]) > 0  # the first attempt overflows
    res_ref, _ = ref.advance(cfg, Scene(), xs)
    res_tiny, _ = tiny.advance(cfg, Scene(), xs)
    assert len(res_ref.mesh.vs) > 0
    for k in ("vs", "ns", "cs"):
        np.testing.assert_array_equal(getattr(res_tiny.mesh, k), getattr(res_ref.mesh, k))
