"""Checkpoint / resume of parameters, optimizer and LR-scheduler state.

Two formats:
  * the JAX package's (`diffsound_tpu/utils/checkpoint.py`): a tree's
    leaves as `leaf_<i>` in `<path>.npz`, its structure and an `extra` dict
    in `<path>.json` (`save_pytree`, `load_pytree`, `load_extra`,
    `TrainCheckpointer.restore`).  Leaves go in `jax.tree.flatten`'s order
    (dict keys sorted; lists, tuples, NamedTuples and dataclasses in order;
    None no leaf), so a file either package writes loads in the other;
  * the port's own: one `torch.save` archive per checkpoint of the params
    and the torch optimizer's and scheduler's state, written to a
    temporary file and renamed into place so a crash never leaves a
    half-written checkpoint (`TrainCheckpointer.maybe_save`, `.load`).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch


def _children(tree):
    """(children, rebuild, treedef text) of a tree node; None for a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ([tree[k] for k in keys], lambda c: dict(zip(keys, c)),
                lambda s: "{" + ", ".join(f"{k!r}: {x}" for k, x in zip(keys, s)) + "}")
    named = isinstance(tree, tuple) and hasattr(tree, "_fields")
    if named or (dataclasses.is_dataclass(tree) and not isinstance(tree, type)):
        # the port's dataclasses (EigenState, ...) stand for JAX's NamedTuples
        children = list(tree) if named else [getattr(tree, f.name)
                                             for f in dataclasses.fields(tree)]
        return (children, lambda c: type(tree)(*c),
                lambda s: f"CustomNode(namedtuple[{type(tree).__name__}], [{', '.join(s)}])")
    if isinstance(tree, (list, tuple)):
        close = ",)" if isinstance(tree, tuple) and len(tree) == 1 else ")"
        text = ((lambda s: "[" + ", ".join(s) + "]") if isinstance(tree, list)
                else (lambda s: "(" + ", ".join(s) + close))
        return list(tree), type(tree), text
    return None


def tree_flatten(tree):
    """(leaves, treedef text) in jax.tree.flatten's leaf order."""
    if tree is None:
        return [], "None"
    node = _children(tree)
    if node is None:
        return [tree], "*"
    children, _, text = node
    leaves, parts = [], []
    for c in children:
        sub, s = tree_flatten(c)
        leaves += sub
        parts.append(s)
    return leaves, text(parts)


def tree_unflatten(like, leaves):
    """A tree shaped like `like` holding `leaves` in tree_flatten's order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        node = _children(t)
        if node is None:
            return next(it)
        children, rebuild, _ = node
        return rebuild([build(c) for c in children])

    return build(like)


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_pytree(path: str, tree, extra: dict = None):
    """Save a tree of tensors or arrays to `<path>.npz` + `<path>.json`."""
    leaves, treedef = tree_flatten(tree)
    np.savez_compressed(path + ".npz", **{f"leaf_{i}": _numpy(v) for i, v in enumerate(leaves)})
    meta = {"treedef": f"PyTreeDef({treedef})", "num_leaves": len(leaves),
            "extra": extra or {}}
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load_pytree(path: str, like):
    """Load into the structure of `like`: each leaf a tensor of the saved
    dtype, on the device of like's leaf where that is a tensor, else on
    the CPU."""
    data = np.load(path + ".npz")
    like_leaves, _ = tree_flatten(like)
    if len(like_leaves) != len(data.files):
        raise ValueError(
            f"checkpoint has {len(data.files)} leaves, template has {len(like_leaves)}"
        )
    leaves = [
        torch.as_tensor(data[f"leaf_{i}"],
                        device=x.device if isinstance(x, torch.Tensor) else "cpu")
        for i, x in enumerate(like_leaves)
    ]
    return tree_unflatten(like, leaves)


def load_extra(path: str) -> dict:
    with open(path + ".json") as f:
        return json.load(f).get("extra", {})


class TrainCheckpointer:
    """Periodic (params, optimizer, scheduler, step) checkpointing with
    resume; `restore` resumes from the JAX package's checkpoints."""

    def __init__(self, out_dir: str, every: int = 500, name: str = "ckpt"):
        os.makedirs(out_dir, exist_ok=True)
        self.base = os.path.join(out_dir, name)
        self.path = self.base + ".pt"
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

    def restore(self, params_like, opt_like):
        """(params, opt_state, step) from the JAX package's `<name>_params`
        and `<name>_opt` pytree files, or None when there are none."""
        if not os.path.exists(self.base + "_params.npz"):
            return None
        params = load_pytree(self.base + "_params", params_like)
        opt_state = load_pytree(self.base + "_opt", opt_like)
        step = load_extra(self.base + "_params").get("step", 0)
        return params, opt_state, step
