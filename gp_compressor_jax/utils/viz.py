"""Headless visualization.

The reference ends every demo in a PCLVisualizer window on its own pthread
(src/asynch_visualizer.cpp) and shells out to octave for debug curves
(src/octave_convenience.cpp:3-44). Neither a display nor octave exists in
a batch job on an accelerator host, so the equivalents here are artifact writers usable from
any process: orthographic point-cloud renders to PNG (pure stdlib: zlib +
struct) and metric curves to SVG — both viewable from any browser/file
viewer, diffable, and cheap enough for per-step logging.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence

import numpy as np


def _write_png(path: str, img: np.ndarray) -> None:
    """img: [H, W, 3] uint8."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def render_cloud(path: str, points: np.ndarray,
                 colors: Optional[np.ndarray] = None,
                 axis: str = "z", size: int = 800,
                 background=(16, 16, 24)) -> None:
    """Orthographic render of a cloud along +x/+y/+z, depth-sorted painter
    style. points: [n, 3]; colors: [n, 3] 0..255 or None (height-colored).
    """
    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    ax = {"x": 0, "y": 1, "z": 2}[axis]
    keep = [i for i in range(3) if i != ax]
    uv = pts[:, keep]
    depth = pts[:, ax]
    lo = uv.min(0)
    hi = uv.max(0)
    span = np.maximum(hi - lo, 1e-9)
    scale = (size - 20) / span.max()
    px = ((uv - lo) * scale + 10).astype(np.int32)
    px = np.clip(px, 0, size - 1)

    if colors is None:
        t = (depth - depth.min()) / max(depth.ptp(), 1e-9)
        colors = np.stack([60 + 180 * t, 80 + 120 * (1 - t),
                           220 - 160 * t], -1)
    colors = np.asarray(colors, np.float64)

    order = np.argsort(depth)          # far first, near painted over
    img = np.zeros((size, size, 3), np.uint8)
    img[:] = background
    img[size - 1 - px[order, 1], px[order, 0]] = colors[order].astype(np.uint8)
    _write_png(path, img)


def plot_series(path: str, series: dict, title: str = "",
                width: int = 720, height: int = 420) -> None:
    """Write labelled 1-D metric curves to an SVG file (the
    octave_convenience::eval_plot_vector role, src/octave_convenience.cpp).
    series: {label: sequence of floats}."""
    pal = ["#4e79a7", "#f28e2b", "#59a14f", "#e15759", "#b07aa1", "#76b7b2"]
    all_vals = np.concatenate([np.asarray(v, float) for v in series.values()])
    finite = all_vals[np.isfinite(all_vals)]
    lo, hi = (finite.min(), finite.max()) if finite.size else (0.0, 1.0)
    if hi - lo < 1e-12:
        hi = lo + 1.0
    mx = max(len(v) for v in series.values())
    m = 45

    def sx(i):
        return m + (width - 2 * m) * (i / max(mx - 1, 1))

    def sy(v):
        return height - m - (height - 2 * m) * ((v - lo) / (hi - lo))

    out = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
           f'height="{height}" style="background:#fff;font-family:sans-serif">']
    out.append(f'<text x="{width/2}" y="20" text-anchor="middle" '
               f'font-size="14">{title}</text>')
    out.append(f'<line x1="{m}" y1="{height-m}" x2="{width-m}" '
               f'y2="{height-m}" stroke="#888"/>')
    out.append(f'<line x1="{m}" y1="{m}" x2="{m}" y2="{height-m}" '
               f'stroke="#888"/>')
    out.append(f'<text x="{m-5}" y="{height-m}" text-anchor="end" '
               f'font-size="10">{lo:.3g}</text>')
    out.append(f'<text x="{m-5}" y="{m+4}" text-anchor="end" '
               f'font-size="10">{hi:.3g}</text>')
    for ci, (label, vals) in enumerate(series.items()):
        vals = np.asarray(vals, float)
        pts = " ".join(f"{sx(i):.1f},{sy(v):.1f}"
                       for i, v in enumerate(vals) if np.isfinite(v))
        col = pal[ci % len(pal)]
        out.append(f'<polyline fill="none" stroke="{col}" stroke-width="1.5" '
                   f'points="{pts}"/>')
        out.append(f'<text x="{width-m}" y="{m + 14 * ci}" text-anchor="end" '
                   f'font-size="11" fill="{col}">{label}</text>')
    out.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(out))
