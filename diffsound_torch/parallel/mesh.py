"""The (dp, ep) process mesh of a multi-pair run.

Counterpart of `diffsound_tpu/parallel/mesh.py`: a 2D logical layout over
the ranks of a torch.distributed world,

  * "dp": data parallel over material pairs (each dp rank trains its own
    slice of the pairs; no gradient crosses it);
  * "ep": element parallel over tetrahedra (the element arrays are split
    over it, and every K @ X / M @ X sums its shards' node vectors with one
    all-reduce).

Ranks are laid out row-major over (dp, ep), as the JAX package reshapes its
device list.  A world of one (no process group) is dp = ep = 1: one card
runs all pairs in one process.  Processes join the group first, with
`init_distributed` (gloo on the CPU, NCCL on CUDA, one card per rank).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from .. import resolve_device


def world() -> tuple:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(device="cuda", rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: Optional[str] = None) -> tuple:
    """Join the process group of a multi-process run: from the arguments,
    else from torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT).  gloo for the CPU, NCCL for CUDA.  A world of one, or a
    group already joined, is left as it is.  Returns (rank, world size)."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size > 1 and not dist.is_initialized():
        if rank is None:
            rank = int(os.environ["RANK"])
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size)
    return world()


@dataclass(frozen=True)
class DeviceMesh:
    dp: int
    ep: int
    dp_rank: int  # this rank's coordinates
    ep_rank: int
    dp_group: Optional[object]  # the ranks that share this rank's ep coordinate
    ep_group: Optional[object]  # the ranks that share this rank's dp coordinate
    device: torch.device

    def pair_slice(self, num_pairs: int) -> slice:
        """This dp rank's contiguous slice of `num_pairs` pairs."""
        if num_pairs % self.dp:
            raise ValueError(f"{num_pairs} pairs do not split over dp = {self.dp}")
        n = num_pairs // self.dp
        return slice(self.dp_rank * n, (self.dp_rank + 1) * n)

    def gather_pairs(self, t: torch.Tensor) -> torch.Tensor:
        """Concatenate every dp rank's (B_local, ...) tensor in dp order."""
        if self.dp == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(self.dp)]
        dist.all_gather(parts, t.contiguous(), group=self.dp_group)
        return torch.cat(parts)

    def ep_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ep shards, in place (no-op at ep = 1)."""
        if self.ep > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.ep_group)
        return t


def make_device_mesh(dp: Optional[int] = None, ep: int = 1, device="cuda") -> DeviceMesh:
    """The (dp, ep) mesh over this process's world; dp defaults to
    world // ep and dp * ep must equal the world size.  Every rank must call
    it (each process group is created by all ranks).  On CUDA each rank
    takes card `rank`; more ranks than cards raise."""
    dev = resolve_device(device)
    rank, n = world()
    if dp is None:
        dp = n // ep
    if dp * ep != n:
        raise ValueError(f"dp*ep = {dp * ep} does not match the world size {n}")
    if dev.type == "cuda" and n > 1:
        if n > torch.cuda.device_count():
            raise RuntimeError(f"{n} CUDA ranks but {torch.cuda.device_count()} cards")
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dp_rank, ep_rank = divmod(rank, ep)
    dp_group = ep_group = None
    if n > 1:
        for e in range(ep):
            g = dist.new_group([d * ep + e for d in range(dp)])
            if e == ep_rank:
                dp_group = g
        for d in range(dp):
            g = dist.new_group([d * ep + e for e in range(ep)])
            if d == dp_rank:
                ep_group = g
    return DeviceMesh(dp, ep, dp_rank, ep_rank, dp_group, ep_group, dev)


def spawn(fn, world_size: int, args=(), device="cpu", timeout: float = 600.0):
    """Run fn(rank, *args) in `world_size` new processes joined in one group
    at tcp://localhost:<a free port> (gloo for the CPU, NCCL for CUDA).
    fn must be importable (a module-level function).  Raises when a rank
    fails, or when the ranks are not done within `timeout` seconds; every
    rank still running then is killed."""
    import multiprocessing
    import socket
    import time

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, port, str(device), args))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.exitcode for p in procs]
            failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                raise RuntimeError(f"ranks failed (rank, exit code): {failed}")
            if all(c == 0 for c in codes):
                return
            if time.monotonic() > deadline:
                late = [r for r, c in enumerate(codes) if c is None]
                raise TimeoutError(f"ranks {late} still running after {timeout} s")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()


def _rank_main(fn, rank, world_size, port, device, args):
    torch.set_num_threads(1)
    init_distributed(device, rank, world_size, f"tcp://localhost:{port}")
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()
