"""Audio IO and host-side signal preprocessing (numpy, scipy and the stdlib
`wave` module).

Counterpart of `diffsound_tpu/audio/io.py`: WAV read and write, dB gain,
polyphase resampling, the RBJ biquad high-pass, and the loader of a
directory of `mic*.wav` recordings with a `metadata.yaml`."""

from __future__ import annotations

import glob
import os
import wave
from fractions import Fraction

import numpy as np


def read_wav(path: str):
    """-> (samples (channels, n) float64 in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as w:
        nch = w.getnchannels()
        width = w.getsampwidth()
        sr = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float64) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float64) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float64) - 128) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3).astype(np.int32)
        val = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        data = val.astype(np.float64) / float(1 << 23)
    else:
        raise ValueError(f"unsupported sample width {width}")
    return data.reshape(-1, nch).T, sr


def write_wav(path: str, samples: np.ndarray, sr: int):
    """samples (channels, n) or (n,) in [-1, 1] -> 16-bit PCM."""
    samples = np.atleast_2d(np.asarray(samples))
    pcm = np.clip(samples.T * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(samples.shape[0])
        w.setsampwidth(2)
        w.setframerate(int(sr))
        w.writeframes(pcm.tobytes())


def gain_db(x: np.ndarray, db: float):
    return x * 10.0 ** (db / 20.0)


def resample(x: np.ndarray, sr_in: int, sr_out: int):
    """Polyphase resampling along the last axis."""
    import scipy.signal as ss

    fr = Fraction(int(sr_out), int(sr_in))
    return ss.resample_poly(x, fr.numerator, fr.denominator, axis=-1)


def highpass_biquad(x: np.ndarray, sr: float, cutoff: float, Q: float = 0.707):
    """RBJ-cookbook biquad high-pass (the filter torchaudio implements)."""
    import scipy.signal as ss

    w0 = 2.0 * np.pi * cutoff / sr
    alpha = np.sin(w0) / (2.0 * Q)
    cos = np.cos(w0)
    b = np.array([(1 + cos) / 2, -(1 + cos), (1 + cos) / 2])
    a = np.array([1 + alpha, -2 * cos, 1 - alpha])
    return ss.lfilter(b / a[0], a / a[0], x, axis=-1)


def _read_metadata(path: str) -> dict:
    """The minimal YAML of a recording directory: lists of numbers under
    top-level keys ("gain:\\n- a\\n- b\\npad:\\n- c\\n- d")."""
    vals, key = {}, None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.endswith(":"):
                key = line[:-1]
                vals[key] = []
            elif line.startswith("-") and key:
                vals[key].append(float(line[1:].strip()))
    return vals


def load_real_audio_dir(audio_dir: str, sample_rate: float, frame_num: int,
                        audio_num: int = 8, highpass_hz: float = 100.0):
    """Load up to audio_num `mic*.wav` recordings (sorted by name, first
    channel each): the metadata's second gain (dB) and pad (seconds cut
    from the start), resampling to sample_rate, the first frame_num
    samples, a high-pass at highpass_hz, per-recording max-normalisation,
    zero padding to frame_num.  Returns (audio (A, frame_num), sr)."""
    meta = os.path.join(audio_dir, "metadata.yaml")
    vals = _read_metadata(meta) if os.path.exists(meta) else {}
    gain, pad = vals.get("gain"), vals.get("pad")

    audios = []
    for path in sorted(glob.glob(os.path.join(audio_dir, "mic*.wav")))[:audio_num]:
        x, sr = read_wav(path)
        x = x[0]
        if gain is not None:
            x = gain_db(x, gain[1])
        if pad is not None:
            x = x[int(pad[1] * sr):]
        x = resample(x, sr, int(sample_rate))[:frame_num]
        x = highpass_biquad(x, sample_rate, highpass_hz)
        x = x / (np.abs(x).max() + 1e-12)
        if len(x) < frame_num:
            x = np.pad(x, (0, frame_num - len(x)))
        audios.append(x)
    return np.stack(audios), sample_rate
