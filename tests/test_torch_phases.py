"""The port's neighbour phases against the JAX package's Pallas phases.

`PallasPhases`, built through `make_phase_objects`, runs in interpret mode on
the CPU; the port's `PbfPhases` runs its plain PyTorch versions there.  Both
get the same sort-time state (one advect, sort and table pass).

Tolerances: diffuse neighbour count exact (integers), diffused colour atol
1e-6; lambda atol 1e-6, rtol 1e-5 (as `test_pallas_interpret.py` holds the
Pallas lambda against its per-pair oracle); pStar after one delta phase atol
1e-5 in simulation units (fp32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbf_sph_tpu.models.jax_solver import JaxSolver, make_phase_objects
from pbf_sph_tpu_torch.core.scene import simple_config_with_2_cubes
from pbf_sph_tpu_torch.core.types import FLUID, Scene
from pbf_sph_tpu_torch.models.torch_solver import (
    TorchSolver,
    advect_and_sort,
    dyn_params_of,
)
from pbf_sph_tpu_torch.ops import phases as ph
from pbf_sph_tpu_torch.ops.grid import decode_key

CASES = {
    # the end-to-end parity scene, capacity 1024
    "2cubes": (700, 2, 500.0),
    # sparse particles on a 9^3-cell grid: many rows share every window,
    # the overlap case of test_pallas_interpret.py
    "sparse": (600, 2, 2500.0),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def frame(request):
    mc, cfg, xs = simple_config_with_2_cubes(*CASES[request.param])
    solver = TorchSolver(h=cfg.h, device="cpu")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    assert spec.capacity == 1024
    dyn = dyn_params_of(cfg, device="cpu")
    fr = advect_and_sort(spec, state, dyn, scn)

    jspec = JaxSolver(h=cfg.h, use_pallas=True).make_spec(cfg, Scene(), spec.capacity)
    assert jspec.grid.extent == spec.grid.extent
    pallas, _ = make_phase_objects(jspec, use_pallas=True)
    key = jnp.asarray(fr.index.key.numpy())
    wins, ovf = pallas.plan_frame(key, jnp.asarray(fr.index.table.numpy()))
    assert int(ovf) == 0
    st = fr.state
    cells, member = decode_key(fr.index.key, spec.grid)
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    jargs = dict(memberf=j(member.float()), ptype=j(st.ptype), alive=j(st.alive),
                 cells=tuple(j(c) for c in cells), pstar=j(fr.pstar), mass=j(st.mass),
                 colour=j(st.colour))
    return dict(spec=spec, dyn=dyn, fr=fr, pallas=pallas, wins=wins, j=jargs)


def test_lambda_matches_pallas(frame):
    fr, ja = frame["fr"], frame["j"]
    st = fr.state
    want = np.asarray(frame["pallas"].lambda_phase(
        frame["wins"], ja["pstar"], ja["mass"], ja["memberf"], ja["ptype"],
        ja["alive"], ja["cells"]))
    phases = ph.PbfPhases(frame["spec"].h)
    got = phases.lambda_phase(fr.index, fr.pstar, st.mass, st.ptype, st.alive)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)
    # the raw plain version, before the mask, gives 1/CFM on non-member rows
    raw = ph.lambda_plain(fr.index, frame["spec"].h, fr.pstar, st.mass)
    dead = fr.index.key >= frame["spec"].grid.ncells
    assert torch.all(raw[dead] == torch.tensor(np.float32(1.0) / np.float32(600.0)))


def test_delta_matches_pallas(frame):
    fr, ja, dyn = frame["fr"], frame["j"], frame["dyn"]
    st, spec = fr.state, frame["spec"]
    lam = frame["pallas"].lambda_phase(
        frame["wins"], ja["pstar"], ja["mass"], ja["memberf"], ja["ptype"],
        ja["alive"], ja["cells"])
    want = np.asarray(frame["pallas"].delta_phase(
        frame["wins"], ja["pstar"], lam, ja["memberf"], ja["ptype"], ja["alive"],
        jnp.float32(spec.scale), jnp.asarray(dyn["min_bound"].numpy()),
        jnp.asarray(dyn["max_bound"].numpy()), ja["cells"]))
    phases = ph.PbfPhases(spec.h)
    got = phases.delta_phase(
        fr.index, fr.pstar, torch.from_numpy(np.asarray(lam)), st.ptype, st.alive,
        torch.tensor(spec.scale, dtype=torch.float32), dyn["min_bound"], dyn["max_bound"])
    assert got.shape == (3, spec.capacity)
    moved = np.abs(want - fr.pstar.numpy()).max()
    assert moved > 0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_diffuse_matches_pallas(frame):
    fr, ja, dyn = frame["fr"], frame["j"], frame["dyn"]
    st, spec = fr.state, frame["spec"]
    pallas = frame["pallas"]
    # the raw neighbour count of the Pallas kernel, as the wrapper packs it
    packed = jnp.stack([
        ja["colour"][0], ja["colour"][1], ja["colour"][2], ja["colour"][3],
        ((ja["ptype"] != 1) & ja["alive"]).astype(jnp.float32) * ja["memberf"],
        jnp.where(ja["memberf"] > 0, ja["cells"][0].astype(jnp.float32), -1e9),
        ja["cells"][1].astype(jnp.float32), ja["cells"][2].astype(jnp.float32)])
    cnt_want = np.asarray(pallas._diffuse(frame["wins"], packed))[4]
    nonobs = ph.nonobstacle(st.ptype, st.alive)
    sums = ph.diffuse_plain(fr.index, st.colour, nonobs)
    np.testing.assert_array_equal(sums[4].numpy(), cnt_want)
    assert cnt_want.max() > 1

    want = np.asarray(pallas.diffuse(
        frame["wins"], ja["colour"], ja["cells"], ja["memberf"], ja["ptype"],
        ja["alive"], jnp.asarray(dyn["dt"].numpy())))
    phases = ph.PbfPhases(spec.h)
    got = phases.diffuse(fr.index, st.colour, st.ptype, st.alive, dyn["dt"])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    fluid = ((st.ptype == FLUID) & st.alive).numpy()
    assert np.abs(want - st.colour.numpy())[:, fluid].max() > 0
