"""Point-splat rasterizer on the state's device, tonemap and PNG export.

Counterpart: ``gpufluidsimulator_tpu/ops/render.py``.  The framebuffer is
a tensor built on the state's device by a bilinear (2x2 tent) splat; 3D
uses an orthographic camera (azimuth / elevation) with depth-shaded
brightness.  ``tonemap`` and ``write_png`` run on the host in numpy and
the standard library (zlib + struct), as the reference's do; this module
keeps its own copies of them and of ``_camera_matrix``.

The splat's sums are exact and so independent of the order in which the
card adds them: each contribution is rounded to a fixed-point integer
(``FIXED_SCALE``) and the integers are added with ``index_add_``.  A
float ``index_add_`` or ``index_put_(accumulate=True)`` on CUDA adds with
atomics, in whatever order the threads arrive, and float addition is not
associative: the same state would give different framebuffers, and PNG
bytes, from one call to the next.  Integer addition is associative, so
the atomics' order no longer matters, and the CPU adds alike.
A stable sort by pixel and a segment sum would also be deterministic,
but costs a sort of four entries per particle.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np
import torch

from ..models.params import SimParams

# fixed-point scale of the splat's sums: contributions are rounded to
# 2^-32 (a pixel's sum is then within 2^-33 per particle of the exact
# one, far below float32's rounding of it), and a pixel holds sums up to
# 2^31 before int64 overflows
FIXED_SCALE = 2.0 ** 32


def _camera_matrix(dim: int, azimuth: float, elevation: float):
    """Rotation mapping world coords -> (right, up, depth) camera coords."""
    if dim == 2:
        return np.eye(2, dtype=np.float32)
    az, el = math.radians(azimuth), math.radians(elevation)
    rz = np.array([[math.cos(az), 0, math.sin(az)],
                   [0, 1, 0],
                   [-math.sin(az), 0, math.cos(az)]], np.float32)
    rx = np.array([[1, 0, 0],
                   [0, math.cos(el), math.sin(el)],
                   [0, -math.sin(el), math.cos(el)]], np.float32)
    return rx @ rz


def _row_sum(a: torch.Tensor) -> torch.Tensor:
    """a[:, 0] + a[:, 1] + ..., added left to right one op at a time.

    A matmul or a ``torch.sum`` over the last axis adds in an order (and
    on the card with fused multiply-adds or TF32) that differs between
    the CPU and the card, which moved a frame of the 1,197,770-particle
    double dam break by 9.1e-6 of its maximum between the two; added one
    op a term, the same frame differed by 6.6e-8 (H100)."""
    out = a[:, 0]
    for j in range(1, a.shape[1]):
        out = out + a[:, j]
    return out


def splat(pos: torch.Tensor, params: SimParams, width: int = 512,
          height: int = 512, weights=None, azimuth: float = 30.0,
          elevation: float = 20.0) -> torch.Tensor:
    """Rasterize particle positions to an intensity framebuffer (H, W) f32
    on ``pos``'s device.  ``weights`` (N,) modulates per-particle intensity
    (e.g. density or speed); default 1.  Corners outside the frame add
    nothing."""
    dev = pos.device
    lo = torch.tensor(params.bounds_min, dtype=torch.float32, device=dev)
    hi = torch.tensor(params.bounds_max, dtype=torch.float32, device=dev)
    cam = torch.from_numpy(_camera_matrix(params.dim, azimuth,
                                          elevation)).to(dev)
    centered = (pos - lo) / (hi - lo) - 0.5            # [-0.5, 0.5]^d
    proj = [_row_sum(centered * cam[k]) for k in range(params.dim)]
    u = (proj[0] + 0.5) * (width - 1)
    v = (0.5 - proj[1]) * (height - 1)                  # y up -> row down
    if params.dim == 3:
        depth = proj[2] + 0.5
        shade = 0.55 + 0.45 * torch.clamp(depth, 0.0, 1.0)
    else:
        shade = torch.ones_like(u)
    w = shade if weights is None else shade * weights

    fu0 = torch.floor(u)
    fv0 = torch.floor(v)
    iu = fu0.to(torch.int64)
    iv = fv0.to(torch.int64)
    fu = u - fu0
    fv = v - fv0

    idx, val = [], []
    for du, dv, cw in ((0, 0, (1 - fu) * (1 - fv)), (1, 0, fu * (1 - fv)),
                       (0, 1, (1 - fu) * fv), (1, 1, fu * fv)):
        px = iu + du
        py = iv + dv
        inside = (px >= 0) & (px < width) & (py >= 0) & (py < height)
        # out-of-frame corners add 0 to pixel 0
        idx.append(torch.where(inside, py * width + px, 0))
        val.append(torch.where(inside, w * cw, 0.0))
    fixed = torch.round(torch.cat(val).double() * FIXED_SCALE).to(torch.int64)
    fb = torch.zeros(height * width, dtype=torch.int64, device=dev)
    fb.index_add_(0, torch.cat(idx), fixed)
    return (fb.double() / FIXED_SCALE).to(torch.float32).reshape(height,
                                                                 width)


def tonemap(fb, gamma: float = 0.45) -> np.ndarray:
    """Intensity framebuffer -> (H, W, 3) uint8 with a water-like ramp."""
    if isinstance(fb, torch.Tensor):
        fb = fb.cpu().numpy()
    fb = np.asarray(fb, np.float64)
    scale = np.percentile(fb[fb > 0], 95.0) if (fb > 0).any() else 1.0
    t = np.clip(fb / max(scale, 1e-9), 0.0, 1.0) ** gamma
    # deep blue -> cyan -> white ramp
    r = np.clip(1.8 * t - 0.8, 0.0, 1.0)
    g = np.clip(1.4 * t - 0.15, 0.0, 1.0)
    b = np.clip(0.25 + 1.1 * t, 0.0, 1.0) * (t > 0) + 0.04 * (t == 0)
    img = np.stack([r, g, b], axis=-1)
    return (img * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Minimal PNG writer (stdlib only). img: (H, W, 3) uint8 or (H, W)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[row].tobytes() for row in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def render_frame(state, params: SimParams, width: int = 512,
                 height: int = 512, color_by: str = "speed",
                 azimuth: float = 30.0, elevation: float = 20.0):
    """State -> intensity framebuffer on the state's device; color_by:
    'speed' | 'density' | 'none'."""
    if color_by == "speed":
        weights = 0.3 + torch.sqrt(_row_sum(state.vel ** 2))
    elif color_by == "density":
        weights = state.rho / params.rest_density
    else:
        weights = None
    return splat(state.pos, params, width, height, weights,
                 azimuth, elevation)


def save_frame(path: str, state, params: SimParams, **kw) -> None:
    fb = render_frame(state, params, **kw)
    write_png(path, tonemap(fb))
