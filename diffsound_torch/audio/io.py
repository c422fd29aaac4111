"""Audio file output (numpy + the stdlib `wave` module).

Counterpart of `diffsound_tpu/audio/io.py::write_wav`."""

from __future__ import annotations

import wave

import numpy as np


def write_wav(path: str, samples: np.ndarray, sr: int):
    """samples (channels, n) or (n,) in [-1, 1] -> 16-bit PCM."""
    samples = np.atleast_2d(np.asarray(samples))
    pcm = np.clip(samples.T * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(samples.shape[0])
        w.setsampwidth(2)
        w.setframerate(int(sr))
        w.writeframes(pcm.tobytes())
