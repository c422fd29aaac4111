"""Multi-pair training step over a (dp, ep) mesh: all material pairs at once.

Counterpart of `diffsound_tpu/parallel/train.py`.  The pairs are a leading
batch dimension; each dp rank holds its slice of them (device tensors passed
to and returned by `step` hold this rank's pairs, `mesh.pair_slice(B)`),
and the element arrays are split over ep (`ShardedFEM`).  Per step:

  * refresh (on the caller's cadence, under no_grad): each pair's Jacobi
    scaling from diag(K) at its own (mu, lambda), then one batched warm
    LOBPCG (`lobpcg_batched`, recompute body) in which K and M are applied
    to all pairs' blocks at once, each pair's K at its own mu and lambda,
    the scaling folded in (`ShardedFEM.k_pairs`, `m_pairs`: on the card one
    launch of the element-apply kernel each);
  * the differentiable part: the modal cache of `models/sound_obj.py`,
        lam~ = lam + mu q_mu + lambda q_lam - lam q_m   (per pair),
    with the quadratic forms recomputed whenever the eigenvectors change
    (the first step and each refresh) and summed over ep once there.  This
    equals the JAX package's per-step Rayleigh correction through the
    sharded K (K is linear in mu, lambda, and U is fixed between refreshes)
    and keeps every collective out of the autograd graph: an all-reduce in
    the graph would leave each ep rank with only its shard's part of the
    gradient;
  * one synthesis call for all local pairs, (B_local, M) frequencies to
    (B_local, T) signals (one launch of each synthesis kernel per step);
  * one loss per pair (the 5-scale L1, or the early-phase geomloss), their
    sum back-propagated so each pair gets exactly its own gradient, and one
    Adam over the stacked (B_local, ...) logits, which is the JAX package's
    vmapped per-pair optax Adam (Adam is elementwise).

The oscillator uses the init material's (alpha, beta) for every pair, as
the JAX trainer does.

While `utils.profiler.tracing()` is open, a step is a `diffsound.step`
span holding `diffsound.refresh` (the batched solve), `diffsound.forms`,
`diffsound.synth`, `diffsound.loss`, `diffsound.backward` and
`diffsound.adam`.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..audio.mss_loss import MSSLoss
from ..fem.assembly import ElementOps
from ..models.material_model import MaterialBins
from ..solvers.diff_eigs import undamped_frequencies
from ..solvers.lobpcg import lobpcg_batched
from ..utils.profiler import span
from .mesh import DeviceMesh
from .ops import ShardedFEM


class MultipairTrainer:
    """The (dp, ep) multi-pair trainer of material_sync-style inference."""

    def __init__(
        self,
        bins: MaterialBins,
        ops: ElementOps,
        osc,
        mesh: DeviceMesh,
        forces: Optional[torch.Tensor] = None,
        n_ffts=(1024, 512, 256, 128, 64),
        sample_rate: float = 32000.0,
        extra_modes: int = 6,
        lr: float = 2e-3,
        refresh_iters: int = 40,
        refresh_tol: float = 1e-3,
    ):
        """refresh_iters/refresh_tol: the warm LOBPCG's budget and exit
        tolerance at a refresh (the caller chooses the cadence with
        step(..., refresh=True))."""
        self.bins = bins
        self.mesh = mesh
        self.osc = osc
        self.forces = None if forces is None else forces.to(mesh.device)
        self.loss = MSSLoss(list(n_ffts), sample_rate, loss_type="l1_loss")
        early_ffts = [n for n in (2048, 1024) if n <= osc.sample_num] or [max(n_ffts)]
        self.loss_early = MSSLoss(early_ffts, sample_rate, loss_type="geomloss")
        self.extra_modes = extra_modes
        self.lr = lr
        self.refresh_iters = refresh_iters
        self.refresh_tol = refresh_tol
        self.fem = ShardedFEM(ops, mesh)
        self.last_refresh_iters = None  # LOBPCG iterations per local pair
        self._forms = None  # (eigvec_b, (3, B_local, k) quadratic forms)
        self._targets = None  # (gt_b, the L1 loss's target cache)

    def solve(self, mu, lam, eigvec_b, max_iters: int, tol: float,
              profiler: Optional[str] = None):
        """Batched warm solve at per-pair Lame values mu, lam (B,) from
        eigvec_b (B, n, k) on the diagonally scaled pencil.  Returns
        (eigval_b, eigvec_b, LOBPCG iterations per pair)."""
        with torch.no_grad(), span("diffsound.refresh"):
            dt = eigvec_b.dtype
            mu, lam = mu.to(dt), lam.to(dt)
            d = self.fem.k_diag(mu, lam)  # (n, B)
            dsc = torch.rsqrt(torch.clamp(d, min=torch.finfo(dt).tiny)).T.contiguous()
            res = lobpcg_batched(
                lambda y: self.fem.k_pairs(y, mu, lam, dsc),
                lambda y: self.fem.m_pairs(y, dsc),
                eigvec_b / dsc[:, :, None], max_iters=max_iters, tol=tol, profiler=profiler,
            )
            return res.eigenvalues, dsc[:, :, None] * res.eigenvectors, res.iterations

    def refresh(self, params_b, eigvec_b, profiler: Optional[str] = None):
        """The warm refresh at every local pair's current material."""
        with torch.no_grad():
            mu, lam = self.bins.lame(params_b)
        return self.solve(mu, lam, eigvec_b, self.refresh_iters, self.refresh_tol, profiler)

    def quadratic_forms(self, eigvec_b):
        """(q_mu, q_lam, q_m), each (B, k), of every pair's eigenvectors."""
        with torch.no_grad(), span("diffsound.forms"):
            return self.fem.quadratic_forms(eigvec_b)

    def _forms_of(self, eigvec_b):
        if self._forms is None or self._forms[0] is not eigvec_b:
            self._forms = (eigvec_b, self.quadratic_forms(eigvec_b))
        return self._forms[1]

    def _target_cache(self, gt):
        if self._targets is None or self._targets[0] is not gt:
            with torch.no_grad():
                self._targets = (gt, self.loss.target_cache(gt))
        return self._targets[1]

    # -- state and step --------------------------------------------------------

    def init(self, num_pairs: int, seed: int = 0, pretrain: bool = True):
        """This rank's pairs' bin logits, every pair the same draw (from a
        CPU generator seeded `seed`), pretrained to the init material's
        table values on the CPU; and their Adam.  Returns (params_b, opt_b):
        a dict of (B_local, K) leaf tensors on the mesh's device, and a
        torch.optim.Adam over them."""
        p0 = self.bins.init_params(torch.Generator().manual_seed(seed))
        if pretrain:
            p0 = self.bins.pretrain(p0)
        sl = self.mesh.pair_slice(num_pairs)
        n = sl.stop - sl.start
        params_b = {k: v.detach()[None].expand(n, *v.shape).to(self.mesh.device).clone()
                    .requires_grad_(True) for k, v in p0.items()}
        return params_b, torch.optim.Adam(list(params_b.values()), lr=self.lr)

    def step(self, params_b, opt_b, eigval_b, eigvec_b, gt_b,
             refresh: bool = False, early: bool = False):
        """One step over this rank's pairs: gt_b (B_local, T) or (B_local,
        1, T); refresh=True first runs the warm refresh; early=True scores
        with the early-phase geomloss.  Updates params_b in place through
        opt_b.  Returns (params_b, opt_b, losses (B,) of all pairs gathered
        over dp, eigval_b, eigvec_b)."""
        with span("diffsound.step"):
            if refresh:
                eigval_b, eigvec_b, self.last_refresh_iters = self.refresh(params_b, eigvec_b)
            opt_b.zero_grad(set_to_none=True)
            losses, _, _ = self.forward(params_b, eigval_b, eigvec_b, gt_b, early)
            with span("diffsound.backward"):
                losses.sum().backward()
            with span("diffsound.adam"):
                self.bins.mask_grads(params_b)
                opt_b.step()
            return params_b, opt_b, self.mesh.gather_pairs(losses.detach()), eigval_b, eigvec_b

    def forward(self, params_b, eigval_b, eigvec_b, gt_b, early: bool = False):
        """The differentiable part of a step for this rank's pairs: (losses
        (B_local,), undamped frequencies (B_local, M), signals (B_local, T))."""
        q_mu, q_lam, q_m = self._forms_of(eigvec_b)
        ev = eigval_b.detach()
        gt = gt_b.reshape(gt_b.shape[0], gt_b.shape[-1])
        mu, lam = self.bins.lame(params_b)
        mu, lam = mu.to(ev.dtype)[:, None], lam.to(ev.dtype)[:, None]
        lams = ev + mu * q_mu + lam * q_lam - ev * q_m
        freqs = undamped_frequencies(lams[:, self.extra_modes:])
        with span("diffsound.synth"):
            sig, damped = self.osc(freqs, self.forces, dtype=gt.dtype)
        with span("diffsound.loss"):
            if early:
                losses = torch.stack([
                    self.loss_early(sig[b:b + 1], gt[b:b + 1], damped[b], 1.0)
                    for b in range(sig.shape[0])
                ])
            else:
                losses = self.loss(sig, None, damped, 1.0,
                                   target_cache=self._target_cache(gt), per_row=True)
        return losses, freqs, sig

    def youngs_poisson(self, params_b):
        """(E, nu) of all pairs, gathered over dp."""
        with torch.no_grad():
            return (self.mesh.gather_pairs(self.bins.youngs(params_b)),
                    self.mesh.gather_pairs(self.bins.poisson(params_b)))
