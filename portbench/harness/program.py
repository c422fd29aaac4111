"""The system under test: diffsound_torch's multi-pair trainer, built as
`train_pairs_parallel` builds it, and driven on the recipe's cadence.

A cycle is one warm batched refresh, between two synchronises, then
`refresh_every` (15) L1 steps (`MultipairTrainer.step`); the first step after a refresh
recomputes the quadratic forms.  Set-up runs the recipe's first 15 steps
(before its first refresh) and one whole cycle, and records on the way
what the correctness check compares: the first three steps' losses, the
first gradient as Adam holds it, the logits before and after the three,
the logits the first refresh runs at, its eigenpairs and the frequencies
of the step after it.
"""

from __future__ import annotations

import time

import torch

def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The trainer and its state on one device."""

    def __init__(self, cfg: dict, inputs: dict, device):
        from diffsound_torch.audio.oscillator import TraditionalOscillatorParams
        from diffsound_torch.experiments.material_sync import MaterialSyncTask, impulse_forces
        from diffsound_torch.fem.material import Material
        from diffsound_torch.fem.mesh import TetMesh
        from diffsound_torch.parallel.mesh import make_device_mesh
        from diffsound_torch.parallel.train import MultipairTrainer

        self.device = torch.device(device)
        mat = tuple(cfg["init_material"])
        task = MaterialSyncTask(
            mesh=TetMesh(inputs["verts"], inputs["tets"], order=cfg["order"]),
            mode_num=cfg["mode_num"], sample_rate=float(cfg["sample_rate"]),
            frame_num=cfg["frame_num"], force_frame_num=cfg["force_frame_num"],
            exp_mode=cfg["exp_mode"], dtype=getattr(torch, cfg["dtype"]), device=self.device)
        if task.mesh_order != cfg["order"]:
            raise ValueError(f"exp_mode {cfg['exp_mode']} trains order {task.mesh_order}, "
                             f"the configuration states order {cfg['order']}")
        model = task._build(mat, task.mesh_order, task.task)
        osc = TraditionalOscillatorParams(1, task.mode_num, task.frame_num, task.sample_rate,
                                          Material.of(mat))
        forces = impulse_forces(1, task.force_frame_num, task.dtype, self.device)
        self.trainer = MultipairTrainer(
            bins=model.bins, ops=model.ops, osc=osc,
            mesh=make_device_mesh(dp=1, ep=1, device=self.device), forces=forces,
            n_ffts=tuple(cfg["n_ffts"]), sample_rate=task.sample_rate,
            extra_modes=cfg["extra_modes"], lr=float(cfg["lr"]),
            refresh_iters=int(cfg["refresh_iters"]), refresh_tol=float(cfg["refresh_tol"]))
        dev, dt = self.device, task.dtype
        B = inputs["targets"].shape[0]
        self.pairs = B
        self.eigval = torch.as_tensor(inputs["theta"], dtype=dt, device=dev)[None].expand(B, -1).clone()
        self.eigvec = torch.as_tensor(inputs["basis"], dtype=dt, device=dev)[None].expand(B, -1, -1).clone()
        self.gt = torch.as_tensor(inputs["targets"], device=dev)
        self.params = {k: torch.as_tensor(v, device=dev).clone().requires_grad_(True)
                       for k, v in inputs["logits"].items()}
        self.opt = torch.optim.Adam(list(self.params.values()), lr=self.trainer.lr)
        self.cycle_len = int(cfg["refresh_every"])
        self.losses = []  # every step's (B,) losses, on the device
        self.refresh_iters = []  # LOBPCG iterations per pair of each refresh

    def step(self):
        t = self.trainer
        self.params, self.opt, loss, self.eigval, self.eigvec = t.step(
            self.params, self.opt, self.eigval, self.eigvec, self.gt)
        self.losses.append(loss)
        return loss

    def refresh(self):
        self.eigval, self.eigvec, its = self.trainer.refresh(self.params, self.eigvec)
        self.refresh_iters.append(list(its))

    def cycle(self, spans=None):
        """One refresh and its steps.  spans (a dict of lists) takes the
        synced seconds of the refresh and of the plain steps after the
        first."""
        dev = self.device
        sync(dev)
        t0 = time.perf_counter()
        self.refresh()
        sync(dev)
        t1 = time.perf_counter()
        self.step()
        if spans is not None:
            sync(dev)
            t2 = time.perf_counter()
        for _ in range(self.cycle_len - 1):
            self.step()
        if spans is not None:
            sync(dev)
            spans["refresh_s"].append(t1 - t0)
            spans["steps_s"].append(time.perf_counter() - t2)

    def setup_steps(self) -> dict:
        """The recipe's steps before its first refresh and one whole cycle,
        recording what
        the check compares (moved to the host)."""
        rec = {"losses": [], "freqs": []}
        orig = self.trainer.forward

        def forward(*a, **k):
            out = orig(*a, **k)
            if keep[0]:
                rec["freqs"].append(out[1].detach().clone())
            return out

        keep = [True]
        planted = "forward" in vars(self.trainer)  # a fault's own wrapper stays
        self.trainer.forward = forward
        try:
            rec["p0"] = {k: v.detach().clone() for k, v in self.params.items()}
            for s in range(self.cycle_len):
                keep[0] = s < 3
                loss = self.step()
                if s < 3:
                    rec["losses"].append(loss)
                if s == 0:
                    st = self.opt.state
                    b1 = self.opt.param_groups[0]["betas"][0]
                    rec["grad"] = {k: st[v]["exp_avg"] / (1.0 - b1) if v in st
                                   else torch.zeros_like(v) for k, v in self.params.items()}
                if s == 2:
                    rec["p3"] = {k: v.detach().clone() for k, v in self.params.items()}
            rec["p_refresh"] = {k: v.detach().clone() for k, v in self.params.items()}
            self.refresh()
            rec["eigval"], rec["eigvec"] = self.eigval.clone(), self.eigvec.clone()
            keep[0] = True
            self.step()
            rec["freqs_after"] = rec["freqs"].pop()
        finally:
            if planted:
                self.trainer.forward = orig
            else:
                del self.trainer.forward
        for _ in range(self.cycle_len - 1):
            self.step()
        sync(self.device)
        return to_host(rec)


def to_host(x):
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, list):
        return [to_host(v) for v in x]
    if torch.is_tensor(x):
        return x.detach().cpu().double().numpy()
    return x


def window(prog: Program, cycles: int, spans=None) -> dict:
    """`cycles` whole cycles; the rate is all the pair-iterations over all
    the time to a synchronise after the last."""
    dev = prog.device
    sync(dev)
    n0 = len(prog.losses)
    its0 = len(prog.refresh_iters)
    t0 = time.perf_counter()
    for _ in range(cycles):
        prog.cycle(spans)
    sync(dev)
    wall = time.perf_counter() - t0
    steps = len(prog.losses) - n0
    return {"cycles": cycles, "steps": steps, "wall_s": wall,
            "pair_iters": steps * prog.pairs, "refresh_iters": prog.refresh_iters[its0:]}
