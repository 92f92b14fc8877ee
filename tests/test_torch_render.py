"""The port's software renderer and checkpoints against the JAX package's,
on CPU.

* `pbf_sph_tpu_torch.utils.render` gives the JAX renderer's images bit for
  bit (the float image and z-buffer arrays, and the PNG bytes) on seeded
  meshes and clouds at 64x48: mesh only, cloud only, composited, an
  oversized triangle, two turntable azimuths; both raise the same
  `ValueError` on empty input;
* an OBJ the JAX package wrote loads to equal arrays through both
  packages' `load_obj_mesh`;
* a checkpoint crosses both ways (JAX -> port, port -> JAX) with equal
  arrays and frame.
"""

import numpy as np
import pytest
import torch

import pbf_sph_tpu.core.types as jtypes
from pbf_sph_tpu.utils import export as jexport
from pbf_sph_tpu.utils import render as jrender
from pbf_sph_tpu_torch.core import types as ttypes
from pbf_sph_tpu_torch.utils import export
from pbf_sph_tpu_torch.utils import render

W, H = 64, 48
PACKAGES = {"jax": (jrender, jtypes), "port": (render, ttypes)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the tier runs several test
    processes at once, and torch's default pool in each of them
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(types, rng, ntri=40, spread=0.08):
    """A seeded triangle soup of small triangles in the unit cube, with
    unnormalised normals and RGBA colours, in `types`' ColouredMesh."""
    centre = np.repeat(rng.uniform(0.1, 0.9, (ntri, 3)), 3, axis=0)
    vs = (centre + rng.normal(0.0, spread, (3 * ntri, 3))).astype(np.float32)
    ns = rng.normal(size=(3 * ntri, 3)).astype(np.float32)
    cs = rng.uniform(0.0, 1.0, (3 * ntri, 4)).astype(np.float32)
    return types.ColouredMesh(vs, ns, cs)


def _cloud(types, rng, n=300):
    return types.ParticleSoA(
        pid=np.arange(n, dtype=np.int32), ptype=np.zeros(n, np.int32),
        mass=np.ones(n, np.float32),
        position=rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32),
        velocity=rng.normal(size=(n, 3)).astype(np.float32),
        colour=rng.uniform(-0.2, 1.2, (n, 4)).astype(np.float32))


def _big_triangle(types):
    """One triangle whose screen box far exceeds `max_block` (the tiling
    path of `render_mesh`)."""
    vs = np.array([[-10, -10, 0], [10, -10, 0], [0, 14, 0]], np.float32)
    ns = np.tile(np.array([[0, 0, 1.0]], np.float32), (3, 1))
    cs = np.tile(np.array([[0.9, 0.2, 0.2, 1.0]], np.float32), (3, 1))
    return types.ColouredMesh(vs, ns, cs)


# case -> (mesh?, cloud?, big triangle?, render_frame keywords)
CASES = {
    "mesh": (True, False, False, {}),
    "cloud": (False, True, False, {}),
    "composited": (True, True, False, {}),
    "oversized": (False, False, True, {}),
    "azimuth_0": (True, True, False, dict(azimuth_deg=0.0, center=(0.5, 0.5, 0.5),
                                          radius=0.9)),
    "azimuth_180": (True, True, False, dict(azimuth_deg=180.0, center=(0.5, 0.5, 0.5),
                                            radius=0.9)),
}


def _draw(pkg, case, tmp_path):
    """(img, zbuf, PNG bytes) of one case through one package: the image by
    `render_mesh`/`render_points` under the camera `render_frame` takes, the
    bytes by `render_frame` itself."""
    R, types = PACKAGES[pkg]
    with_mesh, with_cloud, big, kw = CASES[case]
    rng = np.random.default_rng(19)
    mesh = _big_triangle(types) if big else (_mesh(types, rng) if with_mesh else None)
    xs = _cloud(types, rng) if with_cloud else None
    path = tmp_path / f"{pkg}.png"
    R.render_frame(path, mesh=mesh, xs=xs, width=W, height=H, **kw)

    allv = np.concatenate([np.asarray(g, np.float64) for g in
                           (mesh and mesh.vs, xs and xs.position) if g is not None])
    center = kw.get("center", 0.5 * (allv.min(0) + allv.max(0)))
    radius = kw.get("radius", float(np.linalg.norm(allv.max(0) - allv.min(0))) * 0.5)
    eye = R.orbit_eye(center, radius, kw.get("azimuth_deg", 30.0))
    img = zbuf = None
    if mesh is not None:
        img, zbuf = R.render_mesh(mesh.vs, mesh.ns, mesh.cs, W, H, eye=eye, center=center,
                                  max_block=8 if big else 64)
    if xs is not None:
        img, zbuf = R.render_points(xs.position, xs.colour, W, H, eye=eye, center=center,
                                    img=img, zbuf=zbuf, radius=2)
    return img, zbuf, path.read_bytes()


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_matches_jax_bit_for_bit(case, tmp_path):
    img, zbuf, png = _draw("port", case, tmp_path)
    want_img, want_zbuf, want_png = _draw("jax", case, tmp_path)
    assert img.shape == (H, W, 3) and np.isfinite(zbuf).sum() > 20  # pixels covered
    np.testing.assert_array_equal(img, want_img)
    np.testing.assert_array_equal(zbuf, want_zbuf)
    assert png == want_png and png[:8] == b"\x89PNG\r\n\x1a\n"


def test_render_empty_raises_as_jax(tmp_path):
    for R in (jrender, render):
        with pytest.raises(ValueError, match="nothing to render"):
            R.render_frame(tmp_path / "x.png", mesh=None, xs=None, width=W, height=H)
    assert not (tmp_path / "x.png").exists()


def test_obj_written_by_jax_loads_alike(tmp_path):
    mesh = _mesh(jtypes, np.random.default_rng(4))
    jexport.save_obj_mesh(tmp_path / "m.obj", mesh)
    vs, ns = render.load_obj_mesh(tmp_path / "m.obj")
    want_vs, want_ns = jrender.load_obj_mesh(tmp_path / "m.obj")
    np.testing.assert_array_equal(vs, want_vs)
    np.testing.assert_array_equal(ns, want_ns)
    np.testing.assert_allclose(vs, mesh.vs, atol=1e-5)
    assert vs.shape == (120, 3)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(writer, tmp_path):
    """A checkpoint written by one package resumes in the other: the same
    arrays, dtypes and frame."""
    path = tmp_path / "ckpt_00007.npz"
    save, load, types = ((jexport.save_checkpoint, export.load_checkpoint, jtypes)
                         if writer == "jax" else
                         (export.save_checkpoint, jexport.load_checkpoint, ttypes))
    xs = _cloud(types, np.random.default_rng(8), n=50)
    save(path, xs, 7)
    got, frame = load(path)
    assert frame == 7 and len(got) == 50
    for name in ("pid", "ptype", "mass", "position", "velocity", "colour"):
        want = getattr(xs, name)
        assert getattr(got, name).dtype == want.dtype
        np.testing.assert_array_equal(getattr(got, name), want)
