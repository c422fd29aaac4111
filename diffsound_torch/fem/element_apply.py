"""The element-operator apply of the multi-pair trainer's batched refresh:
K or M applied to every material pair's block at once.

For X in the (B, 3V, k) layout `solvers.lobpcg.lobpcg_batched` holds,
pair b's Lame values mu_b, lam_b (B,) and an optional row scaling s
(B, 3V), the Jacobi scaling of the solve's pencil:

    k_pairs:  Y_b = S_b sum_e P_e^T (mu_b K_mu,e + lam_b K_lam,e) P_e S_b X_b
    m_pairs:  Y_b = S_b sum_e P_e^T (|det A_e| Mref (x) I_3) P_e S_b X_b

with S_b = diag(s_b), or the identity when s is None (M at unit density).

* CUDA tensors launch the hand-written kernel `csrc/element_apply.cu`
  (float32, contiguous, one device, 4 or 10 nodes a tet; anything else
  raises).  The kernel walks each vertex's incidences (`ApplyPlan`, built
  from the tets at first use).
* CPU tensors take `k_pairs_plain` / `m_pairs_plain`: the chain the
  trainer ran before the kernel, each pair's columns side by side through
  `fem.assembly.k_matvec` / `m_matvec`.
* `LAUNCHES` counts launches.

Neither is differentiable: the batched solve and the quadratic forms run
under no_grad.  The geometry, shape, joint and single-pair paths, which
differentiate through the element blocks and X, use `fem.assembly.k_matvec`
and `m_matvec`.

While `utils.profiler.tracing()` is open, each apply is a
`diffsound.fem.k_apply` or `diffsound.fem.m_apply` span and counts
`fem.{k,m}_apply.calls` (one) and `fem.{k,m}_apply.cols` (B k): the plain
versions through `fem.assembly`'s applies, the kernel's launch here, where
each launch also adds one to `fem.apply.kernel`.
"""

from __future__ import annotations

import ctypes
import os
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..utils import nvcc
from ..utils.profiler import count, span
from . import assembly
from .assembly import ElementOps

SOURCE = os.path.join(nvcc.CSRC, "element_apply.cu")
NODES = (4, 10)  # the kernel's element sizes: order 1 and order 2
PATCH = 16  # vertices a block of the kernel walks

LAUNCHES = 0

_lib = None
_lock = threading.Lock()


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(nvcc.build(SOURCE)[0])
            if lib.element_apply_patch_size() != PATCH:
                raise RuntimeError(f"{SOURCE} walks patches of "
                                   f"{lib.element_apply_patch_size()} vertices, the plan {PATCH}")
            fn = lib.element_apply_launch
            fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 10 + \
                [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


@dataclass(frozen=True)
class ApplyPlan:
    """The kernel's walk over one ElementOps, int32 on its device.  The
    vertices in first-touch order of the element list, cut into patches of
    PATCH (a block each), the heaviest first within a patch; each vertex's
    incidences e N + a (element e holds it as node a) in ascending order,
    the order of `ElementOps.gather_idx`; each patch's halo (the nodes of
    its vertices' elements, which the block stages) and each incidence's
    nodes as slots of that halo."""

    order: torch.Tensor  # (V,) the vertex at each walk position
    ptr: torch.Tensor  # (V + 1,) each walk position's incidences in inc and loc
    inc: torch.Tensor  # (E N,)
    loc: torch.Tensor  # (E N, N)
    halo_ptr: torch.Tensor  # (patches + 1,)
    halo: torch.Tensor  # (sum of the halos,)
    max_halo: int


def apply_plan(ops: ElementOps) -> ApplyPlan:
    tets = ops.tets.cpu().numpy()
    E, N = tets.shape
    V = ops.num_vertices
    if tets.size * N >= 2**31 or 3 * V >= 2**31:
        raise ValueError(f"{tets.shape} tets on {V} vertices: past the kernel's int32 indices")
    flat = tets.reshape(-1)
    by_vertex = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=V)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    first = np.where(counts > 0, by_vertex[np.minimum(starts, flat.size - 1)], flat.size)
    order = np.argsort(first, kind="stable")
    patch = np.arange(V) // PATCH
    order = order[np.lexsort((-counts[order], patch))]
    cnt = counts[order]
    ptr = np.concatenate([[0], np.cumsum(cnt)])
    inc = by_vertex[np.repeat(starts[order] - ptr[:-1], cnt) + np.arange(flat.size)]
    pid = np.repeat(patch, cnt)
    keys, slot = np.unique(pid[:, None] * V + tets[inc // N], return_inverse=True)
    halo_ptr = np.searchsorted(keys // V, np.arange(patch[-1] + 2))
    loc = slot.reshape(-1, N) - halo_ptr[pid][:, None]
    as_dev = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32), device=ops.tets.device)
    return ApplyPlan(order=as_dev(order), ptr=as_dev(ptr), inc=as_dev(inc), loc=as_dev(loc),
                     halo_ptr=as_dev(halo_ptr), halo=as_dev(keys % V),
                     max_halo=int(np.diff(halo_ptr).max()))


# ---------------------------------------------------------------------------
# Plain versions (CPU)
# ---------------------------------------------------------------------------


def _columns(x, scale):
    """(B, n, k) -> (n, B k), each pair's columns side by side, scaled."""
    B, n, k = x.shape
    if scale is not None:
        x = scale[:, :, None] * x
    return x.permute(1, 0, 2).reshape(n, B * k)


def _pairs(y, B, scale):
    """(n, B k) -> (B, n, k), scaled."""
    n = y.shape[0]
    y = y.reshape(n, B, -1).permute(1, 0, 2)
    return y if scale is None else scale[:, :, None] * y


def k_pairs_plain(ops: ElementOps, x, mu, lam, scale=None):
    """`k_pairs` by `fem.assembly.k_matvec`, each column at its pair's
    material."""
    B, _, k = x.shape
    y = assembly.k_matvec(ops, _columns(x, scale), mu.repeat_interleave(k),
                          lam.repeat_interleave(k))
    return _pairs(y, B, scale)


def m_pairs_plain(ops: ElementOps, x, scale=None):
    """`m_pairs` by `fem.assembly.m_matvec` at unit density."""
    return _pairs(assembly.m_matvec(ops, _columns(x, scale), 1.0), x.shape[0], scale)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


PLAN_ARRAYS = ("order", "ptr", "inc", "loc", "halo_ptr", "halo")


def _check(fn_name, device, **tensors):
    """Raise unless every tensor is a contiguous float32 (int32 for the
    plan) tensor on `device`, a CUDA device."""
    if device.type != "cuda":
        raise ValueError(f"{fn_name}: x is on {device}, the kernel takes CUDA tensors")
    for name, t in tensors.items():
        want = torch.int32 if name in PLAN_ARRAYS else torch.float32
        if t.device != device:
            raise ValueError(f"{fn_name}: {name} is on {t.device}, x on {device}")
        if t.dtype != want:
            raise TypeError(f"{fn_name}: {name} is {t.dtype}, the kernel takes {want}")
        if not t.is_contiguous():
            raise ValueError(f"{fn_name}: {name} is not contiguous")


def _launch(mass: bool, ops: ElementOps, x, mu, lam, scale, plan: Optional[ApplyPlan]):
    global LAUNCHES
    fn_name = "m_pairs" if mass else "k_pairs"
    N, V = ops.nodes_per_tet, ops.num_vertices
    if x.dim() != 3 or x.shape[1] != 3 * V:
        raise ValueError(f"{fn_name}: x has shape {tuple(x.shape)}, expected (B, {3 * V}, k)")
    if N not in NODES:
        raise ValueError(f"{fn_name}: {N}-node tets; the kernel takes {NODES}")
    B, _, k = x.shape
    plan = apply_plan(ops) if plan is None else plan
    ins = dict(x=x, **{name: getattr(plan, name) for name in PLAN_ARRAYS})
    if mass:
        ins.update(mref=ops.mref, mass_scale=ops.mass_scale)
    else:
        ins.update(k_mu=ops.k_mu, k_lam=ops.k_lam, mu=mu, lam=lam)
        if mu.shape != (B,) or lam.shape != (B,):
            raise ValueError(f"{fn_name}: mu {tuple(mu.shape)}, lam {tuple(lam.shape)}; "
                             f"expected ({B},)")
    if scale is not None:
        ins["scale"] = scale
        if scale.shape != (B, 3 * V):
            raise ValueError(f"{fn_name}: scale has shape {tuple(scale.shape)}, "
                             f"expected ({B}, {3 * V})")
    _check(fn_name, x.device, **ins)
    addr = lambda name: ins[name].data_ptr() if name in ins else None
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _load().element_apply_launch(
            int(mass), N, addr("k_mu"), addr("k_lam"), addr("mref"), addr("mass_scale"),
            *(addr(name) for name in PLAN_ARRAYS), plan.max_halo, addr("x"), addr("mu"),
            addr("lam"), addr("scale"), y.data_ptr(), V, B, k, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: element apply kernel launch failed with cudaError {err}")
    LAUNCHES += 1
    count("fem.apply.kernel")
    return y


def k_pairs(ops: ElementOps, x, mu, lam, scale=None, plan: Optional[ApplyPlan] = None):
    """K(mu_b, lam_b) of every pair's block of x (B, 3V, k), between the
    row scalings `scale` (B, 3V) when given; mu, lam (B,).  plan: the
    kernel's `apply_plan(ops)`, built here when not given."""
    if x.device.type == "cpu":
        return k_pairs_plain(ops, x, mu, lam, scale)
    count("fem.k_apply.calls")
    count("fem.k_apply.cols", x.shape[0] * x.shape[2])
    with span("diffsound.fem.k_apply"):
        return _launch(False, ops, x, mu, lam, scale, plan)


def m_pairs(ops: ElementOps, x, scale=None, plan: Optional[ApplyPlan] = None):
    """M (unit density) of every pair's block of x (B, 3V, k), between the
    row scalings `scale` (B, 3V) when given."""
    if x.device.type == "cpu":
        return m_pairs_plain(ops, x, scale)
    count("fem.m_apply.calls")
    count("fem.m_apply.cols", x.shape[0] * x.shape[2])
    with span("diffsound.fem.m_apply"):
        return _launch(True, ops, x, None, None, scale, plan)
