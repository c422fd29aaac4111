"""The element-operator apply of the batched refresh (`fem/element_apply.py`,
`csrc/element_apply.cu`).

On the CPU: the pairs entry's plain version against `fem.assembly`'s
single-block applies, pair by pair; its spans and counters through
`MultipairTrainer.solve`; the solve through it equal, bit for bit, to the
chain it replaced.  On the card (marked `cuda`): the kernel against the
plain version at the benchmark cells' apply shapes, bit-identical from call
to call, its refusals, and its launches in a batched refresh.

This file imports neither JAX nor the JAX package, so the card's tests run
on a machine that has only PyTorch for CUDA:

    python -m pytest --noconftest tests/test_torch_element_apply.py -q
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_parallel_workers as W
from diffsound_torch.fem import assembly, element_apply
from diffsound_torch.fem.assembly import ElementOps
from diffsound_torch.fem.mesh import cube_tet_mesh
from diffsound_torch.parallel.mesh import make_device_mesh
from diffsound_torch.solvers.lobpcg import lobpcg_batched
from diffsound_torch.utils import profiler

torch.set_num_threads(2)

F64 = torch.float64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the element-apply kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _ops(n, order, size=0.3, device="cpu", dtype=F64):
    mesh = cube_tet_mesh(n, size)
    if order == 2:
        mesh = mesh.to_high_order(2)
    verts = torch.as_tensor(mesh.vertices, dtype=dtype, device=device)
    return assembly.build_element_ops(verts, mesh.tets, order, dtype=dtype)


def _materials(B, dtype=F64, device="cpu", seed=0):
    """Lame values of E in 1e10-1e11 and nu in 0.1-0.4, as the cells draw."""
    rng = np.random.default_rng(seed)
    E, nu = 10.0 ** rng.uniform(10, 11, B), rng.uniform(0.1, 0.4, B)
    mu, lam = E / (2 * (1 + nu)), E * nu / ((1 + nu) * (1 - 2 * nu))
    return (torch.as_tensor(mu, dtype=dtype, device=device),
            torch.as_tensor(lam, dtype=dtype, device=device))


def _jacobi(ops, mu, lam):
    """The solve's row scaling rsqrt(diag K_b), (B, 3V)."""
    return torch.stack([torch.rsqrt(assembly.k_diag(ops, m, l)) for m, l in zip(mu, lam)])


# -- the plain version on the CPU ---------------------------------------------


@pytest.mark.parametrize("order", [1, 2])
def test_plain_pairs_equal_the_single_block_applies(order):
    """k_pairs_plain / m_pairs_plain on (B, 3V, k) at per-pair mu and lam,
    with and without the row scaling, equal assembly.k_matvec / m_matvec of
    each pair's block column for column (float64; the block products of
    B k and of k columns may round in another order)."""
    ops = _ops(2, order)
    B, k = 3, 5
    x = torch.as_tensor(np.random.default_rng(order).standard_normal((B, 3 * ops.num_vertices, k)))
    mu, lam = _materials(B)
    s = _jacobi(ops, mu, lam)
    for scale in (None, s):
        got_k = element_apply.k_pairs_plain(ops, x, mu, lam, scale)
        got_m = element_apply.m_pairs_plain(ops, x, scale)
        for b in range(B):
            d = torch.ones(3 * ops.num_vertices, dtype=F64) if scale is None else scale[b]
            want_k = d[:, None] * assembly.k_matvec(ops, d[:, None] * x[b], mu[b], lam[b])
            want_m = d[:, None] * assembly.m_matvec(ops, d[:, None] * x[b], 1.0)
            for got, want in ((got_k[b], want_k), (got_m[b], want_m)):
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                           atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("n,order", [(3, 2), (4, 1)])
def test_plan_walks_each_incidence_once_in_gather_order(n, order):
    """The kernel's walk (apply_plan): every vertex once; its incidences
    those of gather_idx, in its order (the kernel sums in this order); each
    incidence's nodes found at their slots in its patch's halo."""
    ops = _ops(n, order)
    plan = element_apply.apply_plan(ops)
    tets = ops.tets.numpy()
    N, V = tets.shape[1], ops.num_vertices
    order_, ptr, inc, loc, hp, halo = (getattr(plan, a).cpu().numpy()
                                       for a in element_apply.PLAN_ARRAYS)
    assert sorted(order_) == list(range(V)) and ptr[-1] == tets.size
    gi = ops.gather_idx.numpy()
    for pos, v in enumerate(order_):
        q = inc[ptr[pos]:ptr[pos + 1]]
        np.testing.assert_array_equal(q, gi[v][gi[v] < tets.size])
        patch = pos // element_apply.PATCH
        h = halo[hp[patch]:hp[patch + 1]]
        np.testing.assert_array_equal(h[loc[ptr[pos]:ptr[pos + 1]]], tets[q // N])
    assert plan.max_halo == np.diff(hp).max()


def _trainer(B):
    _, trainer, ev, vec, _ = W.port_setup(make_device_mesh(1, 1, "cpu"))
    mu, lam = _materials(B, seed=1)
    noise = torch.randn((B,) + vec.shape[1:], generator=torch.Generator().manual_seed(0),
                        dtype=F64)
    vec = vec[:1].expand(B, -1, -1) + 1e-2 * noise * vec.abs().max()
    return trainer, mu, lam, vec.contiguous()


def test_solve_emits_the_apply_spans_and_counters():
    """Under tracing(), MultipairTrainer.solve and quadratic_forms count one
    call and B k columns an apply, as fem.assembly's applies did: the
    solve's set-up applies M to x0 and K to X, each sweep K and M to X
    (B k columns) and to S = [X | R | P] (3 B k); the forms K twice and M
    once.  One span an apply; no kernel launch on the CPU."""
    B, sweeps = 2, 3
    trainer, mu, lam, vec = _trainer(B)
    k = vec.shape[2]
    with profile(activities=[ProfilerActivity.CPU]) as prof, profiler.tracing():
        _, _, its = trainer.solve(mu, lam, vec, max_iters=sweeps, tol=0.0)
        trainer.quadratic_forms(vec)
        c = profiler.counters()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert its == [sweeps] * B
    assert c["fem.k_apply.calls"] == names.count("diffsound.fem.k_apply") == 1 + 2 * sweeps + 2
    assert c["fem.m_apply.calls"] == names.count("diffsound.fem.m_apply") == 1 + 2 * sweeps + 1
    assert c["fem.k_apply.cols"] == B * k * (1 + 4 * sweeps + 2)
    assert c["fem.m_apply.cols"] == B * k * (1 + 4 * sweeps + 1)
    assert "fem.apply.kernel" not in c


def test_solve_on_the_cpu_is_the_chain_it_replaced():
    """The solve through ShardedFEM.k_pairs / m_pairs gives the eigenpairs
    of the chain it replaced (each pair's columns side by side through
    assembly.k_matvec and m_matvec, the Jacobi scaling outside) bit for
    bit on the CPU, and the forms the same quadratic forms."""
    B = 2
    trainer, mu, lam, vec = _trainer(B)
    ops = trainer.fem.ops
    n, k = vec.shape[1:]
    dsc = torch.rsqrt(trainer.fem.k_diag(mu, lam)).T[:, :, None]

    def chain(y, apply):
        c = y.shape[2]
        cols = (dsc * y).permute(1, 0, 2).reshape(n, B * c)
        return dsc * apply(cols, c).reshape(n, B, c).permute(1, 0, 2)

    want = lobpcg_batched(
        lambda y: chain(y, lambda x, c: assembly.k_matvec(ops, x, mu.repeat_interleave(c),
                                                          lam.repeat_interleave(c))),
        lambda y: chain(y, lambda x, c: assembly.m_matvec(ops, x, 1.0)),
        vec / dsc, max_iters=4, tol=1e-3)
    ev, evec, its = trainer.solve(mu, lam, vec, max_iters=4, tol=1e-3)
    assert its == want.iterations
    assert torch.equal(ev, want.eigenvalues) and torch.equal(evec, dsc * want.eigenvectors)
    cols = evec.permute(1, 0, 2).reshape(n, B * k)
    q = torch.stack([(cols * assembly.k_matvec(ops, cols, 1.0, 0.0)).sum(0),
                     (cols * assembly.k_matvec(ops, cols, 0.0, 1.0)).sum(0),
                     (cols * assembly.m_matvec(ops, cols, 1.0)).sum(0)]).reshape(3, B, k)
    # the rigid modes' forms are roundoff of terms near the largest: atol
    np.testing.assert_allclose(trainer.quadratic_forms(evec).numpy(), q.numpy(), rtol=1e-13,
                               atol=1e-13 * float(q.abs().max()))


# -- the kernel on the card -----------------------------------------------------


def _as64(ops: ElementOps, absolute=False) -> ElementOps:
    f = (lambda t: t.double().abs()) if absolute else (lambda t: t.double())
    return ElementOps(tets=ops.tets, k_mu=f(ops.k_mu), k_lam=f(ops.k_lam),
                      mass_scale=f(ops.mass_scale), mref=f(ops.mref),
                      num_vertices=ops.num_vertices, gather_idx=ops.gather_idx)


def _case(device, n, order, B, k, seed=0):
    ops = _ops(n, order, device=device, dtype=torch.float32)
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn((B, 3 * ops.num_vertices, k), generator=g, device=device)
    mu, lam = _materials(B, torch.float32, device, seed)
    return ops, x, mu, lam, _jacobi(ops, mu, lam).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("n,order,B,k", [(13, 2, 16, 66), (13, 2, 16, 22), (26, 1, 16, 66),
                                          (6, 2, 3, 21), (6, 2, 3, 200), (8, 1, 3, 100)])
def test_kernel_matches_plain_at_the_cells_shapes(cuda_device, n, order, B, k):
    """K and M, with the solve's Jacobi scaling, at the benchmark cells'
    apply shapes (cube 13 at order 2 and cube 26 at order 1, both 59,049
    DOF; 16 pairs of 22 or 66 columns), and at column counts that take the
    kernel's other staging: an odd count (4-byte copies), more than a
    chunk's 128 columns (several chunks, the last narrower) and four column
    slots a lane with the last partly idle.  Against the plain version in
    float64 on the same float32 inputs.  Tolerance: each entry is a float32 sum of
    L = (incidences of its vertex) x 3N products, each formed with up to
    four roundings, so its error is at most (L + 4) 2^-24 times the same
    sum of absolute values, |K| |X| (the sum order is the kernel's own)."""
    ops, x, mu, lam, s = _case(cuda_device, n, order, B, k)
    plan = element_apply.apply_plan(ops)
    valence = int((plan.ptr[1:] - plan.ptr[:-1]).max())
    tol = (valence * 3 * ops.nodes_per_tet + 4) * 2.0**-24
    before = element_apply.LAUNCHES
    with torch.no_grad():
        got = {"k": element_apply.k_pairs(ops, x, mu, lam, s, plan),
               "m": element_apply.m_pairs(ops, x, s, plan)}
    torch.cuda.synchronize()
    assert element_apply.LAUNCHES - before == 2
    o64, oabs = _as64(ops), _as64(ops, absolute=True)
    x64, mu64, lam64, s64 = x.double(), mu.double(), lam.double(), s.double()
    for b in range(B):
        one = slice(b, b + 1)
        want = {"k": element_apply.k_pairs_plain(o64, x64[one], mu64[one], lam64[one], s64[one]),
                "m": element_apply.m_pairs_plain(o64, x64[one], s64[one])}
        size = {"k": element_apply.k_pairs_plain(oabs, x64[one].abs(), mu64[one], lam64[one],
                                                 s64[one]),
                "m": element_apply.m_pairs_plain(oabs, x64[one].abs(), s64[one])}
        for kind in ("k", "m"):
            err = (got[kind][one].double() - want[kind]).abs()
            worst = float((err / (size[kind] * tol)).max())
            assert worst <= 1.0, (kind, b, worst)


@pytest.mark.cuda
@pytest.mark.parametrize("n,order", [(8, 1), (4, 2)])
def test_kernel_keeps_rigid_motions_near_the_null_space(cuda_device, n, order):
    """K of a rigid motion is zero.  In float32 the kernel leaves no more
    of it than the plain chain does (within 2x a column): it applies mu
    and lambda to the sums of K_mu x and K_lam x, as the chain does;
    rounding each combined entry mu K_mu + lam K_lam instead left 10-30x
    more, and moved the refresh's lowest Ritz values past the benchmark's
    limit at order 1."""
    mesh = cube_tet_mesh(n, 0.3)
    mesh = mesh.to_high_order(2) if order == 2 else mesh
    ops = assembly.build_element_ops(
        torch.as_tensor(mesh.vertices, dtype=torch.float32, device=cuda_device), mesh.tets, order)
    c = torch.as_tensor(mesh.vertices - mesh.vertices.mean(0))
    V = mesh.num_vertices
    cols = []
    for a in range(3):
        t = torch.zeros(V, 3, dtype=F64)
        t[:, a] = 1.0
        cols.append(t)
    for a, b in ((0, 1), (1, 2), (0, 2)):
        t = torch.zeros(V, 3, dtype=F64)
        t[:, a], t[:, b] = -c[:, b], c[:, a]
        cols.append(t)
    r = torch.stack([t.reshape(-1) / t.norm() for t in cols], 1)  # (3V, 6)
    mu, lam = _materials(2, torch.float32, cuda_device, seed=7)
    s = _jacobi(ops, mu, lam).contiguous()
    x = (r.to(cuda_device, torch.float32)[None] / s[:, :, None]).contiguous()  # scaled coordinates
    with torch.no_grad():
        got = element_apply.k_pairs(ops, x, mu, lam, s)
        plain = element_apply.k_pairs_plain(ops, x, mu, lam, s)
    ratio = got.norm(dim=1) / plain.norm(dim=1)
    assert float(ratio.max()) <= 2.0, ratio


@pytest.mark.cuda
def test_kernel_is_bit_identical_call_to_call(cuda_device):
    ops, x, mu, lam, s = _case(cuda_device, 6, 2, 4, 66, seed=3)
    plan = element_apply.apply_plan(ops)
    with torch.no_grad():
        for scale in (None, s):
            k1 = element_apply.k_pairs(ops, x, mu, lam, scale, plan)
            k2 = element_apply.k_pairs(ops, x, mu, lam, scale, plan)
            m1 = element_apply.m_pairs(ops, x, scale, plan)
            m2 = element_apply.m_pairs(ops, x, scale, plan)
            assert torch.equal(k1, k2) and torch.equal(m1, m2)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda_device):
    """CUDA inputs launch the kernel or raise, with no fallback: float64,
    non-contiguous, another device, or tets it has no kernel for."""
    ops, x, mu, lam, s = _case(cuda_device, 2, 2, 2, 8)
    with pytest.raises(TypeError):
        element_apply.k_pairs(ops, x.double(), mu, lam)
    with pytest.raises(TypeError):
        element_apply.m_pairs(_as64(ops), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        element_apply.k_pairs(ops, x.transpose(0, 1).contiguous().transpose(0, 1), mu, lam)
    with pytest.raises(ValueError, match="contiguous"):
        element_apply.m_pairs(ops, x, s.T.contiguous().T)
    with pytest.raises(ValueError, match="cpu"):
        element_apply.k_pairs(ops, x, mu.cpu(), lam)
    with pytest.raises(ValueError, match="shape"):
        element_apply.k_pairs(ops, x[:, 3:], mu, lam)
    mesh = cube_tet_mesh(1, 0.3).to_high_order(3)
    order3 = assembly.build_element_ops(
        torch.as_tensor(mesh.vertices, dtype=torch.float32, device=cuda_device), mesh.tets, 3)
    with pytest.raises(ValueError, match="20-node"):
        element_apply.m_pairs(order3, torch.zeros((1, 3 * mesh.num_vertices, 4),
                                                  device=cuda_device))


@pytest.mark.cuda
def test_batched_refresh_launches_the_kernel(cuda_device):
    """A batched refresh and the forms on the card launch the kernel once
    an apply (LAUNCHES and the fem.apply.kernel counter both equal the K
    and M applies), and its eigenvalues match the CPU's float64 solve."""
    def trainer(dev, dtype):
        osc = W.TraditionalOscillatorParams(1, W.MODES, W.T, W.SR, W.Material.of(W.BASE))
        return W.MultipairTrainer(bins=None, ops=_ops(3, 2, size=0.5, device=dev, dtype=dtype),
                                  osc=osc, mesh=make_device_mesh(1, 1, dev))

    # a converged basis at nearby materials, then a warm refresh on each device
    mu, lam = _materials(3, seed=5)
    tr = trainer("cpu", F64)
    n = 3 * tr.fem.num_vertices
    x0 = torch.randn((n, 12), generator=torch.Generator().manual_seed(0), dtype=F64)
    _, basis, _ = tr.solve(1.05 * mu, 1.05 * lam, x0[None].expand(3, n, 12).contiguous(),
                           max_iters=300, tol=1e-9)
    runs = {}
    for dev, dtype in (("cpu", F64), (cuda_device, torch.float32)):
        tr = trainer(dev, dtype)
        before = element_apply.LAUNCHES
        with profiler.tracing():
            ev, vec, its = tr.solve(mu.to(dev, dtype), lam.to(dev, dtype),
                                    basis.to(dev, dtype), max_iters=40, tol=1e-4)
            tr.quadratic_forms(vec)
            c = profiler.counters()
        runs[str(dev)] = ev.double().cpu()
        if dev == cuda_device:
            torch.cuda.synchronize()
            applies = c["fem.k_apply.calls"] + c["fem.m_apply.calls"]
            assert element_apply.LAUNCHES - before == c["fem.apply.kernel"] == applies
            assert applies == 4 * max(its) + 2 + 3
    card, cpu = runs[str(cuda_device)], runs["cpu"]
    assert float(((card - cpu).abs() / cpu.abs().amax(1, keepdim=True)).max()) < 1e-3
