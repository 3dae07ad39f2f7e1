"""Particles -> rank planes (placement) and rank planes -> particles (gather).

Counterpart: ``gpufluidsimulator_tpu/ops/route.py``.  The reference routes
slot-sorted particles through butterfly networks because the TPU has no
per-lane scatter or gather: ``_placement_kernel`` for the forward direction,
``_extract_kernel`` + ``_stitch_kernel`` for the inverse.  Hopper has both,
so the port keeps the contracts and drops the mechanism:

  * ``place`` (kernel 2, ``csrc/place.cu``): fill every slot with the
    sentinel (position channels) or 0 (velocity channels), then scatter
    ``planes[f].flat[slot[i]] = field_f[i]`` for the particles that landed.
    Kept slots are unique, so the scatter has no conflicts.  No routing
    ``shifts`` channel is produced: nothing reads it.
  * ``gather`` (kernel 5, ``csrc/gather.cu``):
    ``out[i, c] = stack[c].flat[min(slot[i], K*cells - 1)]`` — one kernel in
    place of extract + stitch, whose CPU path computes exactly this.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .planes import LANES, SENTINEL, PlaneGeom


def _plane_shape(geom: PlaneGeom):
    return (geom.k, geom.pz, geom.n_bx, geom.py, LANES)


# --------------------------------------------------------------------------
# kernel 2: placement
# --------------------------------------------------------------------------

def place_plain(fields: torch.Tensor, slot: torch.Tensor, ok: torch.Tensor,
                geom: PlaneGeom, n_pos: int) -> torch.Tensor:
    """(F, N) fields + (N,) int32 slots + (N,) bool -> (F, K, pz, n_bx, py,
    128) planes; channels < n_pos are sentinel-filled, the others 0."""
    f = fields.shape[0]
    m = geom.k * geom.cells
    out = torch.full((f, m), SENTINEL, dtype=torch.float32,
                     device=fields.device)
    out[n_pos:] = 0.0
    idx = slot[ok].to(torch.int64)
    out.index_put_((torch.arange(f, device=fields.device)[:, None],
                    idx[None, :]), fields[:, ok])
    return out.reshape((f,) + _plane_shape(geom))


def place(fields: torch.Tensor, slot: torch.Tensor, ok: torch.Tensor,
          geom: PlaneGeom, n_pos: int) -> torch.Tensor:
    """Placement: the CUDA kernel ``place`` on the card, the plain version
    for CPU tensors.  Slots of ``ok`` particles must be unique."""
    if fields.device.type == "cpu":
        return place_plain(fields, slot, ok, geom, n_pos)
    f, n = fields.shape
    _build.check_tensor(fields, "fields", torch.float32, (f, n))
    _build.check_tensor(slot, "slot", torch.int32, (n,))
    _build.check_tensor(ok, "ok", torch.bool, (n,))
    out = torch.empty((f,) + _plane_shape(geom), dtype=torch.float32,
                      device=fields.device)
    _build.launch("place", fields,
                  _build.ptr(fields), _build.ptr(slot), _build.ptr(ok),
                  _build.ptr(out), ctypes.c_int(n), ctypes.c_int(f),
                  ctypes.c_int(n_pos), ctypes.c_longlong(geom.k * geom.cells))
    return out


# --------------------------------------------------------------------------
# kernel 5: per-particle gather
# --------------------------------------------------------------------------

def gather_plain(stack: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """(C, K, pz, n_bx, py, 128) slot values + (N,) slots -> (N, C)."""
    flat = stack.reshape(stack.shape[0], -1)
    idx = torch.clamp_max(slot.to(torch.int64), flat.shape[1] - 1)
    return flat[:, idx].T.contiguous()


def gather(stack: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Per-particle values out of the planes, in slot-sorted order: the
    CUDA kernel ``gather`` on the card, the plain version for CPU tensors.
    Dropped particles read the last slot; the caller masks them with
    ``ok``."""
    if stack.device.type == "cpu":
        return gather_plain(stack, slot)
    c = stack.shape[0]
    m = stack[0].numel()
    n = slot.shape[0]
    _build.check_tensor(stack, "stack", torch.float32, tuple(stack.shape))
    _build.check_tensor(slot, "slot", torch.int32, (n,))
    out = torch.empty((n, c), dtype=torch.float32, device=stack.device)
    _build.launch("gather", stack,
                  _build.ptr(stack), _build.ptr(slot), _build.ptr(out),
                  ctypes.c_int(n), ctypes.c_int(c), ctypes.c_longlong(m))
    return out
