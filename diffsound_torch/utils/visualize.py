"""Spectrogram comparison figures and render images, written as PNG with
numpy and zlib only.

Counterpart of `diffsound_tpu/utils/visualize.py::save_spec_figure`, which
draws the same side-by-side image with matplotlib; the port needs no
plotting package on the machine that trains."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def spec_image(spec_gt, spec_pred) -> np.ndarray:
    """Side-by-side log-spectrogram image (gt | prediction) as uint8 rows,
    low frequencies at the bottom."""
    img = np.concatenate([np.asarray(spec_gt), np.asarray(spec_pred)], axis=1)
    img = np.nan_to_num(img.astype(np.float64), nan=0.0, posinf=0.0, neginf=0.0)
    lo, hi = float(img.min()), float(img.max())
    scaled = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
    return np.round(scaled[::-1] * 255.0).astype(np.uint8)


def write_png(path: str, img: np.ndarray):
    """8-bit PNG of a (H, W) grayscale or (H, W, 3) RGB uint8 array."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    color = 2 if img.ndim == 3 else 0  # PNG colour type: RGB or grayscale
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))


def save_spec_figure(path, spec_gt, spec_pred):
    write_png(path, spec_image(spec_gt, spec_pred))
