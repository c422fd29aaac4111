"""The port's marching-tets stack against the JAX package's, on the CPU in
float64: the case tables, the background grid, the edge numbering, signed
distances, the marching output row for row, the compacted mesh, the
marched vertices' derivatives, and the OBJ reader and writer.  Inputs are
numpy arrays (an icosphere and an ellipsoid at grid 12, seeded random tet
soups) fed to both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsound_tpu.fem import mesh as jmesh
from diffsound_tpu.geometry import tables as jtables
from diffsound_tpu.geometry.dmtet import MarchingTets as JMarching
from diffsound_tpu.geometry.grid import load_background_grid as jgrid
from diffsound_tpu.geometry.sdf_host import mesh_signed_distance as jsdf
from diffsound_tpu.native import meshops as jops
from tests.test_geometry import icosphere as jax_test_icosphere

from diffsound_torch.fem import mesh as tmesh
from diffsound_torch.geometry import meshops, tables
from diffsound_torch.geometry.dmtet import MarchingTets
from diffsound_torch.geometry.grid import load_background_grid
from diffsound_torch.geometry.sdf_host import mesh_signed_distance

torch.set_num_threads(2)

GRID = 12


def _meshes():
    ball = tmesh.icosphere(2, radius=0.42)
    egg = (ball[0] * np.array([0.95, 0.7, 0.8]), ball[1])
    return {"ball": ball, "egg": egg}


@pytest.fixture(scope="module")
def grid():
    v, t = load_background_grid(GRID, tets_dir="/nonexistent")
    return v.astype(np.float64), t


@pytest.fixture(scope="module")
def sdfs(grid):
    """(JAX numpy, port) signed distances of the grid to each mesh."""
    v, _ = grid
    return {k: (jsdf(v, *m), mesh_signed_distance(v, *m, device="cpu").numpy())
            for k, m in _meshes().items()}


@pytest.mark.parametrize("name", ["NUM_TETS_TABLE", "TET_TABLE", "NUM_TRIS_TABLE", "TRI_TABLE"])
def test_tables_equal_entry_for_entry(name):
    a, b = getattr(jtables, name), getattr(tables, name)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("res", [4, 8])
def test_background_grid_equal(res):
    (jv, jt), (tv, tt) = jgrid(res, "/nonexistent"), load_background_grid(res, "/nonexistent")
    assert np.array_equal(jv, tv) and np.array_equal(jt, tt)


def test_icosphere_is_the_jax_tests_icosphere():
    for sub in (1, 2):
        for x, y in zip(tmesh.icosphere(sub, 0.3), jax_test_icosphere(sub, 0.3)):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("soup", ["grid", "random"])
def test_unique_edges_first_seen_order_equals_native(grid, soup):
    """The native library's first-seen numbering, not the numpy fallback's
    sorted one (edge ids place every edge point in all_verts)."""
    assert jops.native_available()
    tets = grid[1] if soup == "grid" else np.random.default_rng(3).integers(0, 60, (400, 4))
    e_j, ids_j = jops.unique_edges(tets)
    e_t, ids_t = meshops.unique_edges(tets)
    assert np.array_equal(e_j, e_t) and np.array_equal(ids_j, ids_t)


def test_components_match_native():
    rng = np.random.default_rng(5)
    # two separate soups, the second touching nothing of the first
    tets = np.concatenate([rng.integers(0, 40, (30, 4)), rng.integers(50, 90, (12, 4))])
    n_j, lab_j = jops.connected_components(tets, 100)
    n_t, lab_t = meshops.connected_components(tets, 100)
    assert n_j == n_t
    used = np.unique(tets)
    # the same partition of the referenced vertices (the labels' names differ)
    pairs = {(a, b) for a, b in zip(lab_j[used], lab_t[used])}
    assert len(pairs) == len(set(lab_j[used])) == len(set(lab_t[used]))
    keep = tets[:, 0] % 2 == 0
    assert all(np.array_equal(x, y) for x, y in zip(jops.compact_tets(tets, keep),
                                                    meshops.compact_tets(tets[keep])))
    assert all(np.array_equal(x, y) for x, y in zip(jops.face_connected_components(tets),
                                                    meshops.face_connected_components(tets)))


@pytest.mark.parametrize("mesh", ["ball", "egg"])
def test_signed_distance_matches_numpy(sdfs, mesh):
    """The torch arithmetic against the JAX package's numpy to 1e-12 (it
    agrees bit for bit here); the signs must all agree."""
    ref, got = sdfs[mesh]
    assert np.abs(got - ref).max() <= 1e-12
    assert np.array_equal(np.sign(got), np.sign(ref))
    assert (ref > 0).sum() > 100


def _pair(grid, sdf, thickness):
    v, t = grid
    jm, tm = JMarching(v, t), MarchingTets(v, t, device="cpu")
    th_j = None if thickness is None else jnp.asarray(thickness)
    oj = jm(jnp.asarray(v), jnp.asarray(sdf), th_j)
    ot = tm(torch.as_tensor(v), torch.as_tensor(sdf), thickness)
    return oj, ot, tm


CASES = [("ball", 0.5), ("ball", 0.3), ("egg", None), ("ball", None)]


@pytest.mark.parametrize("mesh,coef", CASES)
def test_marching_output_row_for_row(grid, sdfs, mesh, coef):
    sdf = sdfs[mesh][0]
    oj, ot, _ = _pair(grid, sdf, None if coef is None else coef * sdf.max())
    for name in oj._fields:
        a, b = np.asarray(getattr(oj, name)), getattr(ot, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.array_equal(a, b), name


@pytest.mark.parametrize("mesh,coef", CASES)
def test_compact_dicts_equal(grid, sdfs, mesh, coef):
    sdf = sdfs[mesh][0]
    oj, ot, _ = _pair(grid, sdf, None if coef is None else coef * sdf.max())
    cj, ct = JMarching.compact(oj), MarchingTets.compact(ot)
    assert cj.keys() == ct.keys()
    for k in cj:
        assert np.array_equal(np.asarray(cj[k]), np.asarray(ct[k])), k
    assert ct["num_tets"] > 500
    for x, y in zip(JMarching.compact_triangles(oj), MarchingTets.compact_triangles(ot)):
        assert np.array_equal(np.asarray(x), y)


def test_vertices_are_the_gathered_rows(grid, sdfs):
    sdf = sdfs["ball"][0]
    th = 0.4 * sdf.max()
    _, ot, tm = _pair(grid, sdf, th)
    rows = MarchingTets.compact(ot)["keep_idx"]
    got = tm.vertices(torch.as_tensor(grid[0]), torch.as_tensor(sdf), th, rows)
    assert torch.equal(got, ot.all_verts[torch.as_tensor(rows)])


@pytest.mark.parametrize("mesh,coef", [("ball", 0.5), ("egg", None)])
def test_marched_vertex_gradients(grid, sdfs, mesh, coef):
    """d<w, all_verts> with respect to the sdf and the thickness, reverse
    mode in both packages (float64, 1e-12 relative), and the port's
    forward-mode thickness derivative against the same reverse mode."""
    v, t = grid
    sdf = sdfs[mesh][0]
    w = np.random.default_rng(7).standard_normal((len(v) + len(meshops.unique_edges(t)[0]), 3))
    jm, tm = JMarching(v, t), MarchingTets(v, t, device="cpu")
    th = None if coef is None else coef * sdf.max()

    def jloss(s, h):
        return jnp.sum(jm(jnp.asarray(v), s, h).all_verts * w)

    if th is None:
        gj = jax.grad(lambda s: jloss(s, None))(jnp.asarray(sdf))
    else:
        gj, gh_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(sdf), jnp.asarray(th))
    s_t = torch.tensor(sdf, requires_grad=True)
    h_t = None if th is None else torch.tensor(th, dtype=torch.float64, requires_grad=True)
    loss = (tm(torch.as_tensor(v), s_t, h_t).all_verts * torch.as_tensor(w)).sum()
    grads = torch.autograd.grad(loss, [s_t] if th is None else [s_t, h_t])
    scale = np.abs(np.asarray(gj)).max()
    assert scale > 0
    assert np.abs(grads[0].numpy() - np.asarray(gj)).max() <= 1e-12 * scale
    if th is not None:
        assert abs(float(grads[1]) - float(gh_j)) <= 1e-12 * abs(float(gh_j))
        import torch.autograd.forward_ad as fwAD

        with fwAD.dual_level():
            hd = fwAD.make_dual(torch.tensor(th, dtype=torch.float64), torch.ones((), dtype=torch.float64))
            out = tm(torch.as_tensor(v), torch.as_tensor(sdf), hd).all_verts
            tangent = fwAD.unpack_dual(out).tangent
        assert abs(float((tangent * torch.as_tensor(w)).sum()) - float(gh_j)) <= 1e-12 * abs(float(gh_j))


def test_interpolation_clip_derivative_at_the_bounds():
    """Pins JAX's derivative of the clipped interpolation weight at 0 and 1
    (one half, as `maximum`/`minimum` split ties) and the port's, in
    reverse and forward mode: an endpoint whose shifted sdf is exactly 0
    lands there.  `torch.clamp` would give 1."""
    x = np.array([0.0, 1.0, 0.5, -0.2, 1.3])
    want = np.asarray(jax.vmap(jax.grad(lambda u: jnp.clip(u, 0.0, 1.0)))(jnp.asarray(x)))
    assert np.array_equal(want, [0.5, 0.5, 1.0, 0.0, 0.0])
    # two-vertex "grid": sdf on the edge's ends, the weight t = sa / (sa - sb)
    tm = MarchingTets(np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]]),
                      np.array([[0, 1, 2, 3]]), device="cpu")
    pos = torch.as_tensor(tm.grid_verts)
    for sa, sb, dt in ((0.0, -1.0, 0.5), (1.0, 0.0, 0.5), (0.3, -0.2, 1.0)):
        edges = torch.tensor([[0, 1]])
        s = torch.tensor([sa, sb, -1.0, -1.0], dtype=torch.float64, requires_grad=True)
        p = tm._edge_points(pos, s, None, edges)[0, 0]  # x = t along the unit edge
        (g,) = torch.autograd.grad(p, s)
        d = sa - sb
        # u = sa / d: du/dsa = 1/d - sa/d^2, du/dsb = sa/d^2; dt = dt/du
        assert g[:2].tolist() == pytest.approx([dt * (1 / d - sa / d**2), dt * sa / d**2])


def test_obj_round_trip_matches_jax(tmp_path):
    v, f = tmesh.icosphere(1, 0.37)
    tmesh.write_obj(str(tmp_path / "t.obj"), v, f)
    jmesh.write_obj(str(tmp_path / "j.obj"), v, f)
    assert (tmp_path / "t.obj").read_text() == (tmp_path / "j.obj").read_text()
    (tmp_path / "q.obj").write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1/1 2/2 3/3 4/4\n")
    for p in ("t.obj", "q.obj"):
        for x, y in zip(tmesh.read_obj(str(tmp_path / p)), jmesh.read_obj(str(tmp_path / p))):
            assert np.array_equal(x, y) and x.dtype == y.dtype
