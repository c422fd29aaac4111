"""Checkpoint / resume of parameters, optimizer and LR-scheduler state.

One `torch.save` archive per checkpoint, written to a temporary file and
renamed into place so a crash never leaves a half-written checkpoint.
Counterpart of `diffsound_tpu/utils/checkpoint.py`."""

from __future__ import annotations

import os

import torch


class TrainCheckpointer:
    """Periodic (params, optimizer, scheduler, step) checkpointing with resume."""

    def __init__(self, out_dir: str, every: int = 500, name: str = "ckpt"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{name}.pt")
        self.every = every

    def maybe_save(self, step: int, params: dict, optimizer, scheduler):
        if step % self.every == 0:
            state = {
                "step": int(step),
                "params": {k: v.detach().cpu() for k, v in params.items()},
                "optimizer": optimizer.state_dict(),
                "scheduler": scheduler.state_dict(),
            }
            tmp = self.path + ".tmp"
            torch.save(state, tmp)
            os.replace(tmp, self.path)

    def load(self, device="cpu"):
        """The saved state dict, or None when no checkpoint exists."""
        if not os.path.exists(self.path):
            return None
        return torch.load(self.path, map_location=device, weights_only=True)
