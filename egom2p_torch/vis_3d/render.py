"""3-D polylines to an RGB PNG, with numpy and the standard library only.

The root tools draw their PNGs with matplotlib (vis_3d/vis_cam.py:24-47,
vis_3d/cam_viz_tool.py:190-204); the card's machine is promised no
matplotlib, and the port needs no imaging package for its pixels.  So this
module draws the same picture itself:

* matplotlib's default 3-D view (elevation 30 degrees, azimuth -60),
  projected orthographically with numpy;
* a box of equal sides, as `ax.set_box_aspect((1, 1, 1))` gives, each
  axis spanning its own data limits (5% margin on each side), its twelve
  edges drawn in light grey;
* lines rasterised in numpy as round-capped strokes, each polyline blended
  over what is drawn before it at its alpha;
* 1200 x 1200 px (matplotlib's 8 in x 150 dpi), white, written as an
  8-bit RGB PNG with `zlib` and `struct`.

There is no font rasteriser, so the PNG has no title, axis labels, tick
labels or legend: the colours say which track is which (the callers'
docstrings name them).
"""
from __future__ import annotations

import struct
import zlib
from typing import NamedTuple, Sequence

import numpy as np

SIZE = 1200                  # px: 8 in x 150 dpi
ELEV, AZIM = 30.0, -60.0     # matplotlib's default 3-D view, degrees
MARGIN = 0.05                # of an axis's data span, on each side
FILL = 0.45                  # the box's projected half-extent, in image widths
BACKGROUND = (255, 255, 255)
BOX_COLOR = "#d0d0d0"


class Polyline(NamedTuple):
    points: np.ndarray       # (N, 3) data coordinates, N >= 1
    color: str               # "#rrggbb"
    alpha: float = 1.0
    radius: int = 1          # px: the stroke is 2 * radius + 1 wide


def rgb(color: str) -> np.ndarray:
    """"#rrggbb" -> (3,) uint8."""
    return np.array([int(color[i:i + 2], 16) for i in (1, 3, 5)], np.uint8)


def axis_limits(points: np.ndarray) -> np.ndarray:
    """(3, 2) [low, high] of each axis over `points` (N, 3), widened by
    MARGIN; an axis with no extent spans 1 around its value."""
    lo, hi = points.min(0), points.max(0)
    span = np.where(hi > lo, hi - lo, 1.0)
    mid = (lo + hi) / 2
    return np.stack([mid - (0.5 + MARGIN) * span, mid + (0.5 + MARGIN) * span], axis=1)


def _view_axes() -> np.ndarray:
    """(2, 3): the screen's right and up directions in box coordinates."""
    e, a = np.deg2rad(ELEV), np.deg2rad(AZIM)
    right = np.array([-np.sin(a), np.cos(a), 0.0])
    up = np.array([-np.sin(e) * np.cos(a), -np.sin(e) * np.sin(a), np.cos(e)])
    return np.stack([right, up])


_CORNERS = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5)
                     for z in (-0.5, 0.5)])


def project(points: np.ndarray, limits: np.ndarray) -> np.ndarray:
    """(N, 3) data points -> (N, 2) float pixel positions (x right, y down)
    in the box of `limits`."""
    box = (np.asarray(points, np.float64) - limits[:, 0]) / (limits[:, 1] - limits[:, 0]) - 0.5
    axes = _view_axes()
    scale = FILL * SIZE / np.abs(_CORNERS @ axes.T).max()
    xy = box @ axes.T * scale
    return np.stack([SIZE / 2 + xy[:, 0], SIZE / 2 - xy[:, 1]], axis=1)


def _disc(radius: int) -> np.ndarray:
    d = np.arange(-radius, radius + 1)
    dy, dx = np.meshgrid(d, d, indexing="ij")
    keep = dy ** 2 + dx ** 2 <= radius ** 2
    return np.stack([dy[keep], dx[keep]], axis=1)


def draw_polyline(img: np.ndarray, xy: np.ndarray, color: str, alpha: float = 1.0,
                  radius: int = 1) -> None:
    """Blend the stroke through pixel positions `xy` (N, 2) into `img`
    (H, W, 3) uint8 in place: every pixel within `radius` of a point
    sampled each half pixel along the segments takes `color` at `alpha`,
    once however many samples cover it."""
    h, w, _ = img.shape
    a, b = xy[:-1], xy[1:]
    steps = np.maximum(np.ceil(2 * np.linalg.norm(b - a, axis=1)).astype(int), 1)
    pts = [xy[:1]] + [a[i] + (b[i] - a[i]) * (np.arange(1, n + 1)[:, None] / n)
                      for i, n in enumerate(steps)]
    centers = np.rint(np.concatenate(pts)[:, ::-1]).astype(np.int64)   # (row, col)
    cover = (centers[:, None, :] + _disc(radius)[None]).reshape(-1, 2)
    cover = cover[(cover[:, 0] >= 0) & (cover[:, 0] < h) & (cover[:, 1] >= 0) & (cover[:, 1] < w)]
    flat = np.unique(cover[:, 0] * w + cover[:, 1])
    pix = img.reshape(-1, 3)
    blended = (1 - alpha) * pix[flat] + alpha * rgb(color).astype(np.float64)
    pix[flat] = np.rint(blended).astype(np.uint8)


_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_IHDR_RGB8 = (8, 2, 0, 0, 0)   # bit depth, colour type RGB, compression, filter, interlace


def write_png(path: str, img: np.ndarray) -> None:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG (filter 0 on every row)."""
    h, w, c = img.shape
    if c != 3 or img.dtype != np.uint8:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape} {img.dtype}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", struct.pack(">II5B", w, h, *_IHDR_RGB8))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """An 8-bit RGB PNG with filter 0 on every row, as `write_png` writes
    it -> (H, W, 3) uint8.  Raises ValueError on a bad signature or chunk
    CRC, another pixel format, or a row filter other than 0."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != zlib.crc32(tag + body):
            raise ValueError(f"{path}: bad CRC in chunk {tag!r}")
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, *fmt = struct.unpack(">II5B", chunks[b"IHDR"])
    if tuple(fmt) != _IHDR_RGB8 or b"IEND" not in chunks:
        raise ValueError(f"{path}: not an 8-bit RGB PNG without interlace")
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def render_png(path: str, lines: Sequence[Polyline]) -> np.ndarray:
    """Draw `lines` in order over the box (the unit box when there is no
    line) and write the PNG at `path`.  Returns the box's limits (3, 2),
    for `project`."""
    limits = (axis_limits(np.concatenate([np.asarray(l.points, np.float64) for l in lines]))
              if lines else np.array([[0.0, 1.0]] * 3))
    img = np.empty((SIZE, SIZE, 3), np.uint8)
    img[:] = BACKGROUND
    corners = limits[:, 0] + (_CORNERS + 0.5) * (limits[:, 1] - limits[:, 0])
    for i in range(8):
        for j in range(i + 1, 8):
            if np.abs(_CORNERS[i] - _CORNERS[j]).sum() == 1:  # the two ends of an edge
                draw_polyline(img, project(corners[[i, j]], limits), BOX_COLOR, 1.0, 0)
    for line in lines:
        draw_polyline(img, project(line.points, limits), line.color, line.alpha, line.radius)
    write_png(path, img)
    return limits
