"""The port's utilities against the JAX package's on the CPU: checkpoints in
the JAX package's npz + json format read both ways (leaves, `extra`,
`TrainCheckpointer.restore`, the treedef text), the figure writers against
the JAX package's figures (`plot_spec`'s image against the matplotlib
image's array, `plot_signal` against the plotted line, the mode viewer's
magnitudes and labels against what `export_mode_viewer` hands to plotly,
stood in for here), `ThicknessTask.thickness_value`, and the boundary
triangles that the joint CLI and the viewer take from a tet mesh."""

import json
import re
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from diffsound_tpu.geometry.tasks import CoefBins as JBins
from diffsound_tpu.geometry.tasks import ThicknessTask as JThickness
from diffsound_tpu.models.sound_obj import EigenState as JEigenState
from diffsound_tpu.utils import checkpoint as jck
from diffsound_tpu.utils import visualize as jvis

from diffsound_torch.fem.mesh import cube_tet_mesh, icosphere, surface_triangles
from diffsound_torch.geometry.tasks import ThicknessTask
from diffsound_torch.models.sound_obj import EigenState
from diffsound_torch.utils import checkpoint as ck
from diffsound_torch.utils import visualize as vis

torch.set_num_threads(2)

RNG = np.random.default_rng(0)
PARAMS = {"youngs_logits": RNG.uniform(-1, 1, 32).astype(np.float32),
          "poisson_logits": RNG.uniform(-1, 1, 5).astype(np.float32)}


def _jax_tree():
    """A tree with every node kind: dict, list, tuple, NamedTuple, None."""
    eig = JEigenState(jnp.arange(4.0), jnp.ones((6, 4)), jnp.asarray(3), jnp.zeros(4))
    return {"b": [jnp.arange(3, dtype=jnp.int32), (jnp.ones(2, jnp.float32),)],
            "a": None, "eig": eig, "e": ()}


def _port_tree():
    eig = EigenState(torch.arange(4.0, dtype=torch.float64), torch.ones(6, 4, dtype=torch.float64),
                     torch.tensor(3), torch.zeros(4, dtype=torch.float64))
    return {"b": [torch.arange(3, dtype=torch.int32), (torch.ones(2),)], "a": None,
            "eig": eig, "e": ()}


def test_flatten_order_and_treedef_text_are_jax_s():
    jleaves, jdef = jax.tree.flatten(_jax_tree())
    leaves, text = ck.tree_flatten(_jax_tree())
    assert f"PyTreeDef({text})" == str(jdef)
    assert len(leaves) == len(jleaves) == 6
    for a, b in zip(leaves, jleaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    state = optax.adam(1e-3).init(PARAMS)
    assert f"PyTreeDef({ck.tree_flatten(state)[1]})" == str(jax.tree.flatten(state)[1])
    # the port's dataclasses flatten in field order, as JAX's NamedTuples do
    pleaves, _ = ck.tree_flatten(_port_tree())
    assert [tuple(x.shape) for x in pleaves] == [np.shape(x) for x in jleaves]
    rebuilt = ck.tree_unflatten(_port_tree(), pleaves)
    assert isinstance(rebuilt["eig"], EigenState) and rebuilt["a"] is None
    assert isinstance(rebuilt["b"][1], tuple) and rebuilt["e"] == ()


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    path = str(tmp_path / "j")
    jck.save_pytree(path, _jax_tree(), {"step": 7, "note": "jax"})
    got = ck.load_pytree(path, _port_tree())
    assert ck.load_extra(path) == {"step": 7, "note": "jax"}
    for a, b in zip(ck.tree_flatten(got)[0], jax.tree.leaves(_jax_tree())):
        assert isinstance(a, torch.Tensor) and a.dtype == torch.from_numpy(np.array(b)).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert isinstance(got["eig"], EigenState) and got["a"] is None


def test_port_checkpoint_loads_in_jax(tmp_path):
    path = str(tmp_path / "p")
    ck.save_pytree(path, _port_tree(), {"step": 11})
    got = jck.load_pytree(path, _jax_tree())
    assert jck.load_extra(path) == {"step": 11}
    for a, b in zip(jax.tree.leaves(got), ck.tree_flatten(_port_tree())[0]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype
    assert isinstance(got["eig"], JEigenState)
    meta = json.loads((tmp_path / "p.json").read_text())
    assert meta["treedef"] == str(jax.tree.flatten(_jax_tree())[1]) and meta["num_leaves"] == 6
    with pytest.raises(ValueError, match="leaves"):
        ck.load_pytree(path, {"x": torch.zeros(1)})


def test_train_checkpointer_restores_a_jax_run(tmp_path):
    """The JAX package's TrainCheckpointer writes params and optax state at
    step 500; the port's restore reads both back with the step."""
    assert ck.TrainCheckpointer(str(tmp_path)).restore(PARAMS, None) is None
    opt = optax.adam(1e-2)
    params = {k: jnp.asarray(v) for k, v in PARAMS.items()}
    state = opt.init(params)
    for _ in range(3):
        g = jax.tree.map(jnp.ones_like, params)
        upd, state = opt.update(g, state)
        params = optax.apply_updates(params, upd)
    jck.TrainCheckpointer(str(tmp_path), every=500).maybe_save(500, params, state, {"epoch": 2})
    like_p = {k: torch.zeros(v.shape) for k, v in PARAMS.items()}
    like_opt = ({"count": torch.zeros(()), "mu": dict(like_p), "nu": dict(like_p)}, ())
    p, s, step = ck.TrainCheckpointer(str(tmp_path)).restore(like_p, like_opt)
    assert step == 500
    for k in PARAMS:
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(params[k]))
        np.testing.assert_array_equal(s[0]["mu"][k].numpy(), np.asarray(state[0].mu[k]))
        np.testing.assert_array_equal(s[0]["nu"][k].numpy(), np.asarray(state[0].nu[k]))
    assert int(s[0]["count"]) == int(state[0].count) == 3


def test_plot_spec_is_jax_s_figure_image():
    gt, pred = RNG.standard_normal((64, 20)), RNG.standard_normal((64, 20)) + 2.0
    fig = jvis.plot_spec(gt, pred)
    arr = np.asarray(fig.axes[0].images[0].get_array(), np.float64)
    assert fig.axes[0].images[0].origin == "lower"
    img = vis.plot_spec(gt, pred)
    assert img.dtype == np.uint8 and img.shape == arr.shape == (64, 40)
    want = np.round((arr - arr.min()) / (arr.max() - arr.min()) * 255.0)[::-1]
    np.testing.assert_array_equal(img, want)
    assert img[:, :20].mean() < img[:, 20:].mean()  # gt left, prediction right


def test_plot_signal_traces_jax_s_line():
    t = np.arange(3000) / 32000.0
    sig = np.sin(2 * np.pi * 440 * t) * np.exp(-30 * t)
    y = np.asarray(jvis.plot_signal(sig).axes[0].lines[0].get_ydata(), np.float64)
    np.testing.assert_array_equal(y, sig)
    img = vis.plot_signal(sig, width=300, height=200)
    assert img.shape == (200, 300) and set(np.unique(img)) == {0, 255}
    rows = np.round((y.max() - y) / (y.max() - y.min()) * 199).astype(int)
    ink = img == 0
    for col in range(300):
        r = rows[col * 10:(col + 1) * 10]  # 10 samples a column
        span = np.flatnonzero(ink[:, col])
        assert np.array_equal(span, np.arange(span[0], span[-1] + 1)), col
        assert span[0] <= r.min() and r.max() <= span[-1], col
    assert ink[0, np.argmax(y) // 10] and ink[199, np.argmin(y) // 10]
    assert vis.plot_signal(np.zeros(5), 8, 6).shape == (6, 8)


def _viewer_data(path):
    html = open(path).read()
    assert "http" not in html and "src=" not in html  # self-contained
    m = re.search(r'<script type="application/json" id="viewer-data">(.*?)</script>', html, re.S)
    return json.loads(m.group(1))


@pytest.mark.parametrize("layout", ["(3V, M)", "(V, 3, M)"])
def test_mode_viewer_magnitudes_and_labels_are_jax_s(tmp_path, monkeypatch, layout):
    """What the JAX package's export_mode_viewer hands to plotly (a stand-in
    module records it) against what the port writes into its HTML."""
    seen = {}
    go = types.SimpleNamespace(
        Mesh3d=lambda **kw: seen.update(mesh=kw),
        Figure=lambda data: types.SimpleNamespace(
            update_layout=lambda sliders: seen.update(sliders=sliders),
            write_html=lambda path, include_plotlyjs: None))
    monkeypatch.setitem(sys.modules, "plotly", types.SimpleNamespace(graph_objects=go))
    monkeypatch.setitem(sys.modules, "plotly.graph_objects", go)
    verts, faces = icosphere(1)
    shapes = RNG.standard_normal((3 * len(verts), 5))
    if layout == "(V, 3, M)":
        shapes = shapes.reshape(len(verts), 3, 5)
    freqs = [123.456, 800.0, 1234.5678, 5000.04, 9999.99]
    jvis.export_mode_viewer(str(tmp_path / "j.html"), verts, faces, shapes, mode_freqs=freqs)
    out = vis.export_mode_viewer(str(tmp_path / "p.html"), verts, faces, shapes, freqs)
    data = _viewer_data(out)
    steps = seen["sliders"][0]["steps"]
    assert [m["label"] for m in data["modes"]] == [s["label"] for s in steps]
    assert data["modes"][1]["label"] == "mode 1: 800.0 Hz"
    for m, s in zip(data["modes"], steps):
        np.testing.assert_array_equal(np.asarray(m["mag"]), s["args"][0]["intensity"][0])
    np.testing.assert_array_equal(seen["mesh"]["intensity"], np.asarray(data["modes"][0]["mag"]))
    np.testing.assert_array_equal(np.asarray(data["vertices"]), verts)
    np.testing.assert_array_equal(np.asarray(data["faces"]), faces)
    # without modes: the bare mesh; without frequencies: "mode m"
    assert _viewer_data(vis.export_mode_viewer(str(tmp_path / "b.html"), verts, faces))["modes"] == []
    bare = _viewer_data(vis.export_mode_viewer(str(tmp_path / "n.html"), verts, faces, shapes))
    assert [m["label"] for m in bare["modes"]] == [f"mode {m}" for m in range(5)]


def test_thickness_value_matches_jax():
    kw = dict(grid_res=4, scale=1.0, mat="Steel", mode_num=4, tets_dir="/nonexistent")
    j, t = JThickness(**kw), ThicknessTask(**kw, device="cpu")
    ball = icosphere(2, radius=0.42)
    j.apply_sdf(*ball)
    t.apply_sdf(*ball)
    assert t.max_thickness == pytest.approx(j.max_thickness, rel=1e-12)
    logits = np.asarray(JBins(32).init_params(jax.random.PRNGKey(0))["coef_logits"])
    want = float(j.thickness_value({"coef_logits": jnp.asarray(logits)}))
    got = t.thickness_value({"coef_logits": torch.tensor(logits)})
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    assert float(got) == pytest.approx(want, rel=1e-12)
    assert 0 < float(got) < t.max_thickness


@pytest.mark.parametrize("n", [1, 3])
def test_surface_triangles_are_jax_joint_s(n):
    from diffsound_tpu.experiments.joint import _surface_of

    tets = cube_tet_mesh(n, 0.5).corner_tets()
    faces = surface_triangles(tets)
    assert faces.shape == (12 * n * n, 3)
    np.testing.assert_array_equal(faces, _surface_of(tets))
