"""Faults planted under the timed path, for the check's own tests and
readings: each must turn `correct` false.  None of the benchmark's runs
plants one.

  step_unchanged     Adam's update is skipped: a step returns its state
  refresh_unchanged  the refresh hands back the eigenvectors it was given
  half_batch         the second half of the pairs' losses is replaced by the
                     mean of the first half's
  signal_altered     one pair's synthesized signal is scaled by 1.01 where
                     the oscillator produces it
  freq_altered       one pair's undamped frequencies are scaled by 1.001
                     where the step produces them from the eigenvalues
  pair_grad_dropped  one pair's synthesized signal passes no gradient back
                     (a backward that leaves out one row)
  refresh_skips_mode the refresh hands back one pair's eigenpairs without
                     its lowest elastic mode: the modes above it move down
                     a column and the top one is repeated
"""

from __future__ import annotations

import torch

FAULTS = ("step_unchanged", "refresh_unchanged", "half_batch", "signal_altered",
          "freq_altered", "pair_grad_dropped", "refresh_skips_mode")


def _scale_row0(x: torch.Tensor, scale: float) -> torch.Tensor:
    w = torch.ones(x.shape[0], 1, dtype=x.dtype, device=x.device)
    w[0] = scale
    return x * w


class _ScaledRow:
    def __init__(self, osc, scale: float):
        self.osc, self.scale = osc, scale

    def __call__(self, *a, **k):
        sig, damped = self.osc(*a, **k)
        return _scale_row0(sig, self.scale), damped


class _DetachedRow:
    def __init__(self, osc):
        self.osc = osc

    def __call__(self, *a, **k):
        sig, damped = self.osc(*a, **k)
        return torch.cat([sig[:1].detach(), sig[1:]]), damped


class _ScaledFreqs:
    """The trainer's module-level `undamped_frequencies`, row 0 scaled."""

    def __init__(self, fn, scale: float):
        self.fn, self.scale = fn, scale

    def __call__(self, *a, **k):
        return _scale_row0(self.fn(*a, **k), self.scale)


def plant(name: str, prog) -> None:
    """Break `prog` (a harness.program.Program) in place; freq_altered
    breaks the trainer's module for the rest of the process (`heal`)."""
    t = prog.trainer
    if name == "step_unchanged":
        prog.opt.step = lambda *a, **k: None
    elif name == "refresh_unchanged":
        orig = t.refresh

        def refresh(params_b, eigvec_b, profiler=None):
            ev, _, its = orig(params_b, eigvec_b, profiler)
            return ev, eigvec_b, its

        t.refresh = refresh
    elif name == "half_batch":
        orig = t.forward

        def forward(*a, **k):
            losses, freqs, sig = orig(*a, **k)
            h = losses.shape[0] // 2
            rest = losses[:h].mean().expand(losses.shape[0] - h)
            return torch.cat([losses[:h], rest]), freqs, sig

        t.forward = forward
    elif name == "signal_altered":
        t.osc = _ScaledRow(t.osc, 1.01)
    elif name == "pair_grad_dropped":
        t.osc = _DetachedRow(t.osc)
    elif name == "refresh_skips_mode":
        orig = t.refresh
        j = int(t.extra_modes)

        true = []  # pair 0's last refreshed basis, whole

        def refresh(params_b, eigvec_b, profiler=None):
            if true:  # the solver starts from the whole basis, not the one handed out
                eigvec_b = eigvec_b.clone()
                eigvec_b[0] = true.pop()
            ev, vec, its = orig(params_b, eigvec_b, profiler)
            true.append(vec[0].clone())
            keep = [c for c in range(ev.shape[1]) if c != j] + [ev.shape[1] - 1]
            ev, vec = ev.clone(), vec.clone()
            ev[0], vec[0] = ev[0, keep], vec[0][:, keep]
            return ev, vec, its

        t.refresh = refresh
    elif name == "freq_altered":
        import diffsound_torch.parallel.train as train

        if not isinstance(train.undamped_frequencies, _ScaledFreqs):
            train.undamped_frequencies = _ScaledFreqs(train.undamped_frequencies, 1.001)
    else:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")


def heal() -> None:
    """Undo freq_altered's module-level patch."""
    import diffsound_torch.parallel.train as train

    if isinstance(train.undamped_frequencies, _ScaledFreqs):
        train.undamped_frequencies = train.undamped_frequencies.fn
