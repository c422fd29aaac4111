"""Image reconstruction losses with an optional HDR tonemap.

Counterpart of `diffsound_tpu/render/image_loss.py`: mse, l1 (also
"logl1"), smape and relmse, optionally after the `log_srgb` tonemap on both
operands.  The JAX package writes smape's |x| and the tonemap's clamp so
that their gradients follow torch's (1 on the closed interval, 0 at |0|),
and here they are torch's own; its l1 takes `jnp.abs`, whose gradient at 0
is 1 (`abs_l1`)."""

from __future__ import annotations

import torch


def _tonemap_log_srgb(f):
    """log(1 + x) range compression, then the sRGB curve (unclamped above
    1); inputs clamped to [0, 65535]."""
    x = torch.log(torch.clamp(f, 0.0, 65535.0) + 1.0)
    return torch.where(x > 0.0031308, 1.055 * torch.clamp(x, min=0.0031308) ** (1.0 / 2.4) - 0.055,
                       12.92 * x)


def abs_l1(x):
    """|x| whose gradient at 0 is 1, as `jnp.abs`'s (torch.abs's is 0): a
    black pixel matched exactly keeps its gradient."""
    return torch.where(x >= 0, x, -x)


def smape(img, target, eps: float = 0.01):
    """Symmetric mean absolute percentage error."""
    return ((img - target).abs() / (img.abs() + target.abs() + eps)).mean()


def relmse(img, target, eps: float = 0.1):
    """Relative MSE."""
    d = img - target
    return (d * d / (img * img + target * target + eps)).mean()


_LOSSES = {
    "mse": lambda a, b: ((a - b) ** 2).mean(),
    "l1": lambda a, b: abs_l1(a - b).mean(),
    "smape": smape,
    "relmse": relmse,
}


def image_loss_fn(img, target, loss: str = "l1", tonemapper: str = None):
    """loss in {mse, l1, logl1, smape, relmse}; tonemapper None or
    'log_srgb'."""
    if tonemapper == "log_srgb":
        img, target = _tonemap_log_srgb(img), _tonemap_log_srgb(target)
    elif tonemapper not in (None, "none"):
        raise ValueError(f"unknown tonemapper {tonemapper}")
    key = "l1" if loss == "logl1" else loss
    if key not in _LOSSES:
        raise ValueError(f"unknown image loss {loss}")
    return _LOSSES[key](img, target)


def make_image_loss(loss: str = "l1", tonemapper: str = None):
    """The loss as a callable (img, target) -> scalar."""
    return lambda img, target: image_loss_fn(img, target, loss, tonemapper)
