"""The port on the card: the synthesis kernels, forward and backward, against
their plain versions (also at the material_real GT bank's tables), their
autograd function and dispatch, short material_sync and material_real
runs on CUDA, the shape march, the geometry loss-gradient pass, the
joint task's loss-gradient pass and the flagship forward step.

These tests import neither JAX nor the JAX package, so they run on a
machine that has only PyTorch for CUDA.  tests/conftest.py imports JAX, so
there they run without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a card every test skips."""

import math

import numpy as np
import pytest
import torch

from diffsound_torch.audio import synth_kernel
from diffsound_torch.audio.oscillator import synth_constant_modes
from diffsound_torch.audio.synth_kernel import (
    SynthFn, synth_constant_modes_bwd_plain, synth_constant_modes_plain,
)

torch.set_num_threads(2)

SR = 32000.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the synthesis kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _modes(A, M, device, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.as_tensor(x.astype(np.float32), device=device)
        for x in (rng.uniform(100, 8000, (A, M)), rng.uniform(1, 100, (A, M)),
                  rng.uniform(0.1, 1, (A, M)))
    )


@pytest.mark.cuda
@pytest.mark.parametrize("A,M,T", [(1, 16, 8000), (8, 256, 8000), (3, 40, 1000), (2, 1500, 300)])
def test_kernel_matches_plain(cuda_device, A, M, T):
    f, d, a = _modes(A, M, cuda_device, seed=A + M)
    before = synth_kernel.LAUNCHES
    out = synth_kernel.synth_kernel(f, d, a, T, SR)
    torch.cuda.synchronize()
    assert synth_kernel.LAUNCHES == before + 1
    assert out.shape == (A, T) and out.dtype == torch.float32
    ref = synth_constant_modes_plain(f, d, a, T, SR)
    # f32 sums of M terms, each with an f32-rounded phase and envelope
    bound = 1e-5 * a.abs().sum(dim=1, keepdim=True)
    assert bool(((out - ref).abs() <= bound).all())


def _bwd_errors(got, f, d, a, g, T):
    """Per gradient, max|got - ref| / max|ref| against the plain backward in
    float64 on the card, and the same for the plain backward in float32,
    the witness of what float32 alone costs."""
    ref = synth_constant_modes_bwd_plain(f.double(), d.double(), a.double(), g.double(), T, SR)
    f32 = synth_constant_modes_bwd_plain(f, d, a, g, T, SR)
    rel = lambda x, y: float((x.double() - y).abs().max() / y.abs().max())
    return [rel(x, y) for x, y in zip(got, ref)], [rel(x, y) for x, y in zip(f32, ref)]


@pytest.mark.cuda
def test_synthfn_grads_and_dispatch(cuda_device):
    f, d, a = (x.requires_grad_(True) for x in _modes(2, 16, cuda_device, seed=5))
    before, before_bwd = synth_kernel.LAUNCHES, synth_kernel.LAUNCHES_BWD
    out = synth_constant_modes(f, d, a, 1000, SR)
    assert synth_kernel.LAUNCHES == before + 1
    g = torch.autograd.grad(out.square().sum(), (f, d, a))
    assert synth_kernel.LAUNCHES_BWD == before_bwd + 1
    err, witness = _bwd_errors(g, f.detach(), d.detach(), a.detach(), 2 * out.detach(), 1000)
    print(f"SynthFn backward rel err {err}, plain f32 {witness}")
    assert max(err) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("A,M,T", [(1, 16, 8000), (8, 256, 8000), (3, 40, 1000), (2, 1500, 300)])
def test_bwd_kernel_matches_plain(cuda_device, A, M, T):
    f, d, a = _modes(A, M, cuda_device, seed=A + M)
    g = torch.randn((A, T), generator=torch.Generator(cuda_device).manual_seed(M),
                    device=cuda_device)
    before = synth_kernel.LAUNCHES_BWD
    got = synth_kernel.synth_kernel_bwd(f, d, a, g, T, SR)
    torch.cuda.synchronize()
    assert synth_kernel.LAUNCHES_BWD == before + 1
    assert all(x.shape == (A, M) and x.dtype == torch.float32 for x in got)
    err, witness = _bwd_errors(got, f, d, a, g, T)
    print(f"backward kernel ({A},{M},{T}) rel err {err}, plain f32 {witness}")
    assert max(err) <= 1e-4
    again = synth_kernel.synth_kernel_bwd(f, d, a, g, T, SR)
    assert all(torch.equal(x, y) for x, y in zip(got, again))  # no atomics: bit-identical


@pytest.mark.cuda
def test_synthfn_backward_of_a_sum_takes_the_stride_0_cotangent(cuda_device):
    f, d, a = (x.requires_grad_(True) for x in _modes(2, 64, cuda_device, seed=9))
    out = SynthFn.apply(f, d, a, 8000, SR)
    before = synth_kernel.LAUNCHES_BWD
    g = torch.autograd.grad(out.sum(), (f, d, a))  # autograd hands an expanded ones
    assert synth_kernel.LAUNCHES_BWD == before + 1
    ones = torch.ones((2, 8000), device=cuda_device)
    err, witness = _bwd_errors(g, f.detach(), d.detach(), a.detach(), ones, 8000)
    print(f"SynthFn backward of out.sum() rel err {err}, plain f32 {witness}")
    assert max(err) <= 1e-4


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda_device):
    f, d, a = _modes(2, 16, cuda_device)
    with pytest.raises(TypeError):
        synth_constant_modes(f.double(), d.double(), a.double(), 1000, SR)
    with pytest.raises(TypeError):
        synth_kernel.synth_kernel(f.double(), d, a, 1000, SR)
    with pytest.raises(ValueError):
        synth_kernel.synth_kernel(f.t().contiguous().t(), d, a, 1000, SR)
    with pytest.raises(ValueError):
        synth_kernel.synth_kernel(f, d.cpu(), a, 1000, SR)
    g = torch.ones((2, 1000), device=cuda_device)
    with pytest.raises(ValueError):
        synth_kernel.synth_kernel_bwd(f, d, a, g[:, :999], 1000, SR)
    with pytest.raises(ValueError):
        synth_kernel.synth_kernel_bwd(f, d, a, torch.ones((2, 1), device=cuda_device).expand(2, 1000), 1000, SR)
    with pytest.raises(TypeError):
        synth_kernel.synth_kernel_bwd(f, d, a, g.double(), 1000, SR)


@pytest.mark.cuda
def test_kernels_take_the_gt_bank_dampings(cuda_device):
    """The GT bank's tables: dampings up to 5e4 1/s (alpha to 600, beta to
    1e-5 at up to 16 kHz), over-damped modes with the damped frequency
    clamped to 1.6e-7 Hz.  Underflowing envelopes give zeros, never NaN, in
    the forward and in every gradient."""
    A, M, T = 8, 256, 8000
    rng = np.random.default_rng(3)
    f = rng.uniform(20.0, 16000.0, (A, M))
    alpha = np.exp(rng.uniform(np.log(0.6), np.log(600.0), (A, M)))
    beta = np.exp(rng.uniform(np.log(1e-8), np.log(1e-5), (A, M)))
    f[:, 0], alpha[:, 0] = 20.0, 600.0  # over-damped: d > 2 pi f
    d = 0.5 * (alpha + beta * (2 * np.pi * f) ** 2)
    fd = np.sqrt(np.maximum((2 * np.pi * f) ** 2 - d**2, 1e-12)) / (2 * np.pi)
    a = rng.uniform(0.5, 0.52, (A, M))
    assert d.max() > 4e4 and (fd < 1e-6).any()
    f, d, a = (torch.as_tensor(x, dtype=torch.float32, device=cuda_device) for x in (fd, d, a))
    out = synth_kernel.synth_kernel(f, d, a, T, SR)
    ref = synth_constant_modes_plain(f, d, a, T, SR)
    assert torch.isfinite(out).all()
    assert ((out - ref).abs() <= 1e-5 * a.abs().sum(dim=1, keepdim=True)).all()
    g = torch.randn((A, T), generator=torch.Generator(cuda_device).manual_seed(0),
                    device=cuda_device)
    got = synth_kernel.synth_kernel_bwd(f, d, a, g, T, SR)
    want = synth_constant_modes_bwd_plain(f.double(), d.double(), a.double(), g.double(), T, SR)
    for x, y in zip(got, want):
        assert torch.isfinite(x).all()
        assert float((x.double() - y).abs().max() / y.abs().max()) <= 1e-4


@pytest.mark.cuda
def test_material_real_short_run_on_cuda(cuda_device):
    """Stage 1 launches both kernels every step; stage 2 runs on the card."""
    from diffsound_torch.audio.damping import DampingCurve
    from diffsound_torch.experiments.material_real import fit_gt_oscillator, train_material_real
    from diffsound_torch.fem.mesh import cube_tet_mesh

    t = (np.arange(2000) + 1) / SR
    audio = np.stack([np.exp(-30 * t) * np.sin(2 * np.pi * f * t) for f in (900.0, 2300.0)])
    forces = torch.zeros((2, 150))
    forces[:, 0] = 1.0
    before = (synth_kernel.LAUNCHES, synth_kernel.LAUNCHES_BWD)
    _, params, losses = fit_gt_oscillator(audio, forces, 64, SR, (2700, 7.2e10, 0.19, 6, 1e-7),
                                             iters=20, verbose=False)
    assert synth_kernel.LAUNCHES - before[0] == 20
    assert synth_kernel.LAUNCHES_BWD - before[1] == 20
    assert params["amp_raw"].is_cuda and np.isfinite(losses).all()
    xs = np.linspace(100.0, 16000.0, 50)
    res = train_material_real(cube_tet_mesh(3, 0.5), audio, DampingCurve(xs, 4.0 + 1e-3 * xs),
                              (2700, 7.2e10, 0.19, 6, 1e-7), mode_num=8, max_epoch=16,
                              early_loss_epoch=1, verbose=False)
    assert np.isfinite(res["losses"]).all() and len(res["refresh_iters"]) == 1
    assert math.isfinite(res["youngs"]) and math.isfinite(res["poisson"])


@pytest.mark.cuda
def test_material_sync_short_run_on_cuda(cuda_device):
    from diffsound_torch.experiments.material_sync import MaterialSyncTask
    from diffsound_torch.fem.mesh import cube_tet_mesh

    task = MaterialSyncTask(mesh=cube_tet_mesh(3, 0.5), mode_num=8, frame_num=2000)
    assert task.device.type == "cuda" and task.dtype == torch.float32
    gt_audio, gt_freqs = task.make_gt((2700, 7.2e10, 0.19, 6, 1e-7))
    assert gt_audio.is_cuda and np.isfinite(gt_freqs).all()
    before = synth_kernel.LAUNCHES
    res = task.train((2700, 6.6e10, 0.23, 6, 1e-7), gt_audio, max_epoch=30,
                     early_loss_epoch=0, late_freq_weight=0.0, verbose=False)
    assert synth_kernel.LAUNCHES - before >= 30
    assert np.isfinite(res["losses"]).all() and len(res["refresh_iters"]) == 1
    assert math.isfinite(res["youngs"]) and math.isfinite(res["poisson"])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["thickness", "morphing"])
def test_shape_march_on_cuda_equals_cpu(cuda_device, kind):
    """The shape path's float64 signed distances, marching output and
    compact mesh on the card equal the CPU's bit for bit (the CPU's equal
    the JAX package's, tests/test_torch_shape_marching.py), and the warm
    solve and forward-mode Ritz pass run on CUDA."""
    from diffsound_torch.fem.mesh import icosphere
    from diffsound_torch.geometry.dmtet import MarchingTets
    from diffsound_torch.geometry.tasks import MorphingTask, ThicknessTask

    ball = icosphere(2, 0.42)
    egg = (ball[0] * np.array([0.95, 0.7, 0.8]), ball[1])
    tasks = {}
    for dev in ("cpu", "cuda"):
        if kind == "thickness":
            t = ThicknessTask(grid_res=16, scale=1.0, mat="Steel", mode_num=6, device=dev)
            t.apply_sdf(*ball)
        else:
            t = MorphingTask(grid_res=16, scale=1.0, mat="Steel", mode_num=6, device=dev)
            t.apply_sdf2(*ball, *egg)
        tasks[dev] = t
    sdf = {d: (t.sdf if kind == "thickness" else t.sdf1) for d, t in tasks.items()}
    assert torch.equal(sdf["cuda"].cpu(), sdf["cpu"])
    outs = {d: t._march_coef(0.55) for d, t in tasks.items()}
    for name in outs["cpu"]._fields:
        assert torch.equal(getattr(outs["cuda"], name).cpu(), getattr(outs["cpu"], name)), name
    comps = {d: MarchingTets.compact(o) for d, o in outs.items()}
    for k in comps["cpu"]:
        assert np.array_equal(np.asarray(comps["cuda"][k]), np.asarray(comps["cpu"][k])), k
    t = tasks["cuda"]
    t._eigensolve(outs["cuda"], comps["cuda"])  # cold anchor
    out2 = t._march_coef(0.57)
    comp2 = MarchingTets.compact(out2)
    vals, U = t._eigensolve(out2, comp2)
    assert t.warm.last_mode == "warm" and torch.is_tensor(U) and U.is_cuda
    ritz, dvals = t._coef_vals_jac(0.57, comp2, U)
    ref, _ = t._eigensolve_host(out2, comp2)
    # the warm solve converged to the float32 tolerance (residual 3e-3)
    assert np.abs(ritz / ref[6:] - 1).max() < 1e-3 and np.isfinite(dvals).all()


@pytest.mark.cuda
def test_geometry_loss_gradient_pass_on_cuda(cuda_device):
    """The geometry task's loss-gradient pass on the card, at one CPU
    compaction and host basis (grid 12, hidden 64): in float64 equal to the
    CPU's (1e-10 in the losses, 1e-7 in relative norm of the gradients); in
    float32 the loss within 1e-5 of float64, the eigenvalue loss within
    1e-3, the loss's gradient within 1e-5 and the eigenvalue loss's
    gradient in the MLP's parameters within 5e-2 in relative norm (the
    CPU's float32 reads 4.2e-7, 9.5e-5, 3.7e-7 and 5.0e-3 here; a zero
    gradient reads 1), every gradient finite.  The float32 eigenvalue
    gradient in every parameter and in deform is not gated: deform's part,
    a per-vertex field that sliver tets dominate, reads 0.29 on the CPU."""
    import chip_smoke
    from diffsound_torch.geometry.dmtet import MarchingTets
    from diffsound_torch.geometry.geometry_task import GeometryTask
    from diffsound_torch.geometry.sdf_mlp import SDFGeometry

    def task(dev):
        t = GeometryTask(grid_res=12, scale=1.0, freq_num=1, mode_num=8, eig_method="host",
                         device=dev)
        t.geo = SDFGeometry(t.grid_verts, 12, 1.0, 1, hidden_dim=64, device=dev)
        return t

    cpu, card = task("cpu"), task(cuda_device)
    p = cpu.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    q = rng.uniform(-0.5, 0.5, (2000, 3))
    sd = 0.32 - np.linalg.norm(q, axis=1)
    p = cpu.pretrain_sdf(p, q, 0.38 - np.linalg.norm(q, axis=1), iters=300, lr=1e-3)
    out = cpu._march_params(p)
    comp = MarchingTets.compact(out)
    _, U = cpu._eigensolve_host(out, comp, 14)
    target = cpu._eigensolve_host(out, comp, 14)[0][6:] * 0.9
    ref = chip_smoke.geometry_pass(cpu, p, comp, U, target, torch.as_tensor(q),
                                   torch.as_tensor(sd))
    n_def = p["deform"].numel()
    on_card = lambda dt: {"mlp": {k: v.to(cuda_device, dt) for k, v in p["mlp"].items()},
                          "deform": p["deform"].to(cuda_device, dt)}
    # gates in chip_smoke.GEOMETRY_GAPS' order
    for dt, gates in ((torch.float64, (1e-10, 1e-10, 1e-7, 1e-7, 1e-7, 1e-7)),
                      (torch.float32, (1e-5, 1e-3, 1e-5, 5e-2))):
        got = chip_smoke.geometry_pass(card, on_card(dt), comp, U, target,
                                       torch.as_tensor(q, device=cuda_device, dtype=dt),
                                       torch.as_tensor(sd, device=cuda_device, dtype=dt))
        assert np.isfinite(got[2].numpy()).all() and np.isfinite(got[3].numpy()).all()
        gaps = chip_smoke.geometry_gaps(got, ref, n_def)
        assert all(g <= gate for g, gate in zip(gaps, gates)), (dt, gaps)


@pytest.mark.cuda
def test_joint_step_on_cuda_matches_cpu(cuda_device):
    """The joint task's loss-gradient pass on the card against the CPU's at
    one CPU march's compaction, padded surface, host basis and jitter noise
    (grid 10, hidden 32, light_res 8, 4 + 6 modes, 32^2), the task in
    float64 on both devices (the render float32 on both): the audio loss
    within 1e-9, the loss and the image loss within 1e-4, each parameter
    group's gradient within 1e-2 in relative norm (float32 renders whose
    products round in another order), at most 2 pixels in 1,024 whose
    winning triangle differs; then the card's own step in float32 (warm
    solver, first solve cold) finite."""
    import chip_smoke
    from diffsound_torch.experiments.joint import look_at_mvp
    from diffsound_torch.geometry.dmtet import MarchingTets
    from diffsound_torch.geometry.joint_task import JointImageAudioTask
    from diffsound_torch.utils.tree import tree_leaves, tree_unflatten
    from diffsound_torch.render import rasterize
    from diffsound_torch.render.util import xfm_points

    kw = dict(grid_res=10, mode_num=4, light_res=8, hidden_dim=32, tets_dir="/nonexistent",
              dtype=torch.float64)
    cpu = JointImageAudioTask(device="cpu", **kw)
    card = JointImageAudioTask(device=cuda_device, **kw)
    p = cpu.init_params(torch.Generator().manual_seed(0))
    p["geo"] = cpu.geo.pretrain_regression(
        p["geo"], cpu.grid_verts, 0.35 - np.linalg.norm(cpu.grid_verts, axis=-1), iters=300,
        lr=3e-4)
    out = cpu._march_host(p)
    comp = MarchingTets.compact(out)
    tric, v_tex, t_tex_idx, _ = cpu.surface(out, 512)
    lam, U = cpu._eigensolve_host(out, comp, 10)
    campos = np.array([0.4, 0.5, 2.7])
    mvp = look_at_mvp(campos)
    img = np.zeros((32, 32, 4), np.float32)
    img[9:23, 7:25] = (0.6, 0.5, 0.4, 1.0)
    noise = torch.randn((32, 32, 3), generator=torch.Generator().manual_seed(1))
    args = (comp, tric, v_tex, t_tex_idx, lam, U, lam[6:] * 1.1, img, mvp, campos, 0.1)
    ref = cpu.loss_grad(p, *args, noise, 0.5, 0.02, (32, 32))
    pc = tree_unflatten(p, [x.to(cuda_device) for x in tree_leaves(p)])
    got = card.loss_grad(pc, *args, noise.to(cuda_device), 0.5, 0.02, (32, 32),
                         tri_gidx=card._tri_gather(tric))
    rel = lambda a, b: abs(a.item() / b.item() - 1)
    assert rel(got[1][2], ref[1][2]) <= 1e-9
    assert rel(got[0], ref[0]) <= 1e-4 and rel(got[1][0], ref[1][0]) <= 1e-4
    for name in chip_smoke.JOINT_GROUPS:
        a, b = chip_smoke.joint_group(got[2], name), chip_smoke.joint_group(ref[2], name)
        assert torch.isfinite(a).all() and float((a - b).norm() / b.norm()) <= 1e-2, name
    v32, m32 = out.all_verts.float(), torch.as_tensor(mvp, dtype=torch.float32)
    ids = [rasterize.rasterize(xfm_points(v32.to(d), m32.to(d)),
                               torch.as_tensor(tric["tris"], device=d), (32, 32),
                               tri_mask=torch.as_tensor(tric["tri_mask"], device=d),
                               with_soft=False)[0].tri_id.cpu() for d in (cuda_device, "cpu")]
    assert int((ids[0] != ids[1]).sum()) <= 2
    f32 = JointImageAudioTask(device=cuda_device, **{**kw, "dtype": torch.float32})
    loss, aux, g, *_ = f32.step_loss_grad(pc, lam[6:] * 1.1, img, mvp, campos, 0.1,
                                          noise.to(cuda_device), 0.5, resolution=(32, 32),
                                          tri_bucket=512)
    assert torch.isfinite(loss) and all(torch.isfinite(x).all() for x in tree_leaves(g))


@pytest.mark.cuda
def test_multipair_step_on_cuda_matches_cpu(cuda_device):
    """The multi-pair trainer at B = 4 on the card in f32 against the CPU in
    f64, from the same logits, eigenpairs and targets: each step launches
    each synthesis kernel once for all four pairs; the first step's losses
    within 1e-4 and its Adam step within 1e-3 lr; a refresh's eigenvalues
    within 1e-3 of the CPU's."""
    from diffsound_torch.audio.oscillator import TraditionalOscillatorParams
    from diffsound_torch.experiments.material_sync import (
        MaterialSyncTask, flagship_material_pairs, impulse_forces,
    )
    from diffsound_torch.fem.material import Material
    from diffsound_torch.fem.mesh import cube_tet_mesh
    from diffsound_torch.parallel.mesh import make_device_mesh
    from diffsound_torch.parallel.train import MultipairTrainer

    pairs = flagship_material_pairs(4)
    host = MaterialSyncTask(mesh=cube_tet_mesh(3, 0.5), mode_num=8, frame_num=2000,
                            device="cpu")
    gt = torch.cat([host.make_gt(g)[0] for _, g in pairs])
    model = host._build(pairs[0][0], 2, host.task)
    eig = model.eigen_decomposition()
    runs = {}
    for dev, dtype in (("cpu", torch.float64), ("cuda", torch.float32)):
        m = host._build(pairs[0][0], 2, host.task) if dev == "cpu" else MaterialSyncTask(
            mesh=host.mesh, mode_num=8, frame_num=2000)._build(pairs[0][0], 2, host.task)
        tr = MultipairTrainer(
            bins=m.bins, ops=m.ops, mesh=make_device_mesh(1, 1, dev),
            osc=TraditionalOscillatorParams(1, 8, 2000, 32000.0, Material.of(pairs[0][0])),
            forces=impulse_forces(1, 150, dtype, dev), lr=2e-3)
        params, opt = tr.init(4, pretrain=False)
        before = {k: v.detach().clone() for k, v in params.items()}
        ev = eig.eigenvalues.to(dev, dtype)[None].expand(4, -1).clone()
        evec = eig.eigenvectors.to(dev, dtype)[None].expand(4, -1, -1).clone()
        g = gt.to(dev, dtype)
        counts = (synth_kernel.LAUNCHES, synth_kernel.LAUNCHES_BWD)
        losses = []
        for i, refresh in enumerate((False, False, True)):
            params, opt, loss, ev, evec = tr.step(params, opt, ev, evec, g, refresh=refresh)
            if i == 0:
                step = {k: (params[k].detach() - before[k]).double().cpu() for k in params}
            losses.append(loss.double().cpu())
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (synth_kernel.LAUNCHES - counts[0], synth_kernel.LAUNCHES_BWD - counts[1]) \
                == (3, 3)
        runs[dev] = dict(losses=losses, step=step, ev=ev.double().cpu())
    cpu, card = runs["cpu"], runs["cuda"]
    assert all(torch.isfinite(x).all() for x in card["losses"])
    assert float((card["losses"][0] / cpu["losses"][0] - 1).abs().max()) < 1e-4
    assert max(float((card["step"][k] - cpu["step"][k]).abs().max()) for k in cpu["step"]) \
        < 1e-3 * 2e-3
    assert float((card["ev"][:, 6:] / cpu["ev"][:, 6:] - 1).abs().max()) < 1e-3


@pytest.mark.cuda
def test_entry_step_on_cuda_matches_cpu(cuda_device):
    """The flagship forward step (`diffsound_torch.entry`) on the card: one
    forward and backward launch each synthesis kernel once; its f32 loss and
    gradients against the CPU's f64 at the same arguments within
    chip_smoke's gates (4x the CPU's own f32 gap there, at least the
    kernels' 2^-22)."""
    import chip_smoke
    from diffsound_torch.entry import entry

    fn, args = entry("cuda")
    counts = (synth_kernel.LAUNCHES, synth_kernel.LAUNCHES_BWD)
    card = chip_smoke.entry_step(fn, args, "cuda", torch.float32)
    torch.cuda.synchronize()
    assert (synth_kernel.LAUNCHES - counts[0], synth_kernel.LAUNCHES_BWD - counts[1]) == (1, 1)
    cpu64 = chip_smoke.entry_step(entry("cpu")[0], args, "cpu", torch.float64)
    own = chip_smoke.entry_gaps(chip_smoke.entry_step(entry("cpu", dtype=torch.float32)[0], args,
                                                      "cpu", torch.float32), cpu64)
    gates = chip_smoke.entry_gates(own)
    for k, gap in chip_smoke.entry_gaps(card, cpu64).items():
        assert gap <= gates[k], k
