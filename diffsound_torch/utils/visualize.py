"""Spectrogram and waveform images, written as PNG with numpy and zlib only,
and a self-contained HTML viewer of a surface mesh's mode shapes.

Counterpart of `diffsound_tpu/utils/visualize.py`, which draws with
matplotlib and writes plotly HTML; the port needs no plotting package on
the machine that trains.  `plot_spec` and `plot_signal` return uint8
images (save them with `write_png`) where the JAX package returns
matplotlib figures."""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np


def plot_spec(spec_gt, spec_pred) -> np.ndarray:
    """Side-by-side log-spectrogram image (gt | prediction) as uint8 rows,
    low frequencies at the bottom."""
    img = np.concatenate([np.asarray(spec_gt), np.asarray(spec_pred)], axis=1)
    img = np.nan_to_num(img.astype(np.float64), nan=0.0, posinf=0.0, neginf=0.0)
    lo, hi = float(img.min()), float(img.max())
    scaled = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
    return np.round(scaled[::-1] * 255.0).astype(np.uint8)


def plot_signal(signal, width: int = 640, height: int = 480) -> np.ndarray:
    """Waveform image of a 1-D signal, uint8 (height, width): black on
    white, the signal's maximum on the top row and its minimum on the
    bottom one; each column spans its samples and the line from the sample
    before them."""
    x = np.asarray(signal, np.float64).reshape(-1)
    if len(x) < width:  # at least one sample a column
        x = np.interp(np.linspace(0, len(x) - 1, width), np.arange(len(x)), x)
    lo, hi = x.min(), x.max()
    rows = (np.round((hi - x) / (hi - lo) * (height - 1)) if hi > lo
            else np.full(len(x), height // 2)).astype(np.int64)
    cols = np.arange(len(x)) * width // len(x)
    prev = np.concatenate([rows[:1], rows[:-1]])
    top, bottom = np.full(width, height), np.full(width, -1)
    np.minimum.at(top, cols, np.minimum(rows, prev))
    np.maximum.at(bottom, cols, np.maximum(rows, prev))
    r = np.arange(height)[:, None]
    return np.where((r >= top) & (r <= bottom), 0, 255).astype(np.uint8)


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
    write_png(path, plot_spec(spec_gt, spec_pred))


_VIEWER = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>mode viewer</title>
<style>body{margin:0;font-family:sans-serif}#bar{padding:6px}canvas{display:block}</style>
</head><body>
<div id="bar"><select id="mode"></select> drag to rotate</div>
<canvas id="view" width="800" height="700"></canvas>
<script type="application/json" id="viewer-data">__DATA__</script>
<script>
const D = JSON.parse(document.getElementById("viewer-data").textContent);
const V = D.vertices, F = D.faces, cv = document.getElementById("view");
const ctx = cv.getContext("2d"), sel = document.getElementById("mode");
const c = [0, 1, 2].map(k => V.reduce((s, v) => s + v[k], 0) / V.length);
const r = V.reduce((m, v) => Math.max(m, Math.hypot(v[0] - c[0], v[1] - c[1], v[2] - c[2])), 0) || 1;
let yaw = 0.6, pitch = 0.4, drag = null;
D.modes.forEach((m, i) => sel.add(new Option(m.label, i)));
// viridis, five stops
const ramp = [[68, 1, 84], [59, 82, 139], [33, 145, 140], [94, 201, 98], [253, 231, 37]];
function colour(t, shade) {
  t = Math.min(Math.max(t, 0), 1) * 4;
  const i = Math.min(Math.floor(t), 3), f = t - i;
  return "rgb(" + [0, 1, 2].map(k => Math.round(shade *
    (ramp[i][k] + f * (ramp[i + 1][k] - ramp[i][k])))).join(",") + ")";
}
function draw() {
  const mag = D.modes.length ? D.modes[sel.value].mag : null;
  const top = mag ? mag.reduce((m, x) => Math.max(m, x), 0) || 1 : 1;
  const cy = Math.cos(yaw), sy = Math.sin(yaw), cp = Math.cos(pitch), sp = Math.sin(pitch);
  const s = 0.45 * Math.min(cv.width, cv.height) / r;
  const P = V.map(v => {
    const x = v[0] - c[0], y = v[1] - c[1], z = v[2] - c[2];
    const x1 = cy * x + sy * z, z1 = -sy * x + cy * z;
    return [x1, cp * y - sp * z1, sp * y + cp * z1];
  });
  const order = F.map((f, i) => i).sort((a, b) =>
    F[a].reduce((s, k) => s + P[k][2], 0) - F[b].reduce((s, k) => s + P[k][2], 0));
  ctx.clearRect(0, 0, cv.width, cv.height);
  for (const i of order) {
    const [a, b, e] = F[i].map(k => P[k]);
    const nz = (b[0] - a[0]) * (e[1] - a[1]) - (b[1] - a[1]) * (e[0] - a[0]);
    const n = Math.hypot(nz, (b[1] - a[1]) * (e[2] - a[2]) - (b[2] - a[2]) * (e[1] - a[1]),
                         (b[2] - a[2]) * (e[0] - a[0]) - (b[0] - a[0]) * (e[2] - a[2])) || 1;
    const t = mag ? F[i].reduce((s, k) => s + mag[k], 0) / (3 * top) : 0.5;
    ctx.fillStyle = colour(t, 0.45 + 0.55 * Math.abs(nz) / n);
    ctx.beginPath();
    [a, b, e].forEach((p, j) => (j ? ctx.lineTo : ctx.moveTo).call(ctx,
      cv.width / 2 + s * p[0], cv.height / 2 - s * p[1]));
    ctx.closePath();
    ctx.fill();
  }
}
cv.onmousedown = e => { drag = [e.clientX, e.clientY]; };
window.onmouseup = () => { drag = null; };
cv.onmousemove = e => {
  if (!drag) return;
  yaw += 0.01 * (e.clientX - drag[0]);
  pitch += 0.01 * (e.clientY - drag[1]);
  drag = [e.clientX, e.clientY];
  draw();
};
sel.onchange = draw;
draw();
</script></body></html>
"""


def export_mode_viewer(path: str, vertices, faces, mode_shapes=None, mode_freqs=None):
    """Write one self-contained HTML file (no external script, no network)
    that draws the surface mesh coloured by each mode's per-vertex
    displacement magnitude, with a mode selector labelled "mode m: f Hz".

    vertices (V, 3), faces (F, 3); mode_shapes optional (V, 3, M) or
    (3V, M); mode_freqs optional (M,) in Hz.  Returns path."""
    vertices = np.asarray(vertices, np.float64)
    modes = []
    if mode_shapes is not None:
        ms = np.asarray(mode_shapes, np.float64)
        if ms.ndim == 2:  # (3V, M), xyz interleaved per vertex
            ms = ms.reshape(len(vertices), 3, -1)
        mags = np.linalg.norm(ms, axis=1)  # (V, M)
        for m in range(mags.shape[1]):
            label = f"mode {m}: {mode_freqs[m]:.1f} Hz" if mode_freqs is not None else f"mode {m}"
            modes.append({"label": label, "mag": mags[:, m].tolist()})
    data = {"vertices": vertices.tolist(), "faces": np.asarray(faces, np.int64).tolist(),
            "modes": modes}
    with open(path, "w") as f:
        f.write(_VIEWER.replace("__DATA__", json.dumps(data).replace("</", "<\\/")))
    return path
