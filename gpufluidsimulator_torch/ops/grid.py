"""Uniform-grid neighbour structure: cell hashing and a fixed-capacity cell
table.

Counterpart: ``gpufluidsimulator_tpu/ops/grid.py``; plain PyTorch, as the
reference is plain XLA (it has no Pallas kernel).  The grid carries a ghost
ring of ``halfwidths`` cells per axis, so every stencil offset of an interior
cell is a valid linear offset.  ``build_cell_table`` bins particles into a
dense ``(C, K, ...)`` table:

  1. padded cell id per particle (``cell_id``)
  2. stable ``argsort`` by cell id
  3. rank within the cell from a ``searchsorted`` of the sorted ids
  4. scatter into slot ``cell * K + rank``; ranks >= K are dropped and
     counted in ``overflow``

Empty slots hold the far-away ``SENTINEL`` position, so every smoothing
kernel evaluates to exactly 0 against them.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..models.params import SimParams

# Sentinel position of an empty slot: outside every kernel support, small
# enough that r^2 stays finite in float32.
SENTINEL = 1.0e6


def halfwidths(params: SimParams) -> Tuple[int, ...]:
    """Per-axis stencil halfwidth: 1 for cells >= h, ceil(h / cell) on a
    finer axis (``SimParams.cell_aniso``)."""
    return tuple(max(1, int(math.ceil(params.h / c - 1e-6)))
                 for c in params.cells_axis)


def padded_res(params: SimParams) -> Tuple[int, ...]:
    return tuple(r + 2 * hw
                 for r, hw in zip(params.grid_res, halfwidths(params)))


def num_padded_cells(params: SimParams) -> int:
    return math.prod(padded_res(params))


def strides(params: SimParams) -> Tuple[int, ...]:
    """Linearisation strides of the padded grid, axis 0 fastest."""
    pr = padded_res(params)
    s = [1]
    for r in pr[:-1]:
        s.append(s[-1] * r)
    return tuple(s)


def neighbor_offsets(params: SimParams) -> Tuple[int, ...]:
    """Sorted linear cell offsets of the stencil: 3^d for cubic cells, a
    finer axis widened to 2 * halfwidth + 1 offsets."""
    st = strides(params)
    hws = halfwidths(params)
    offs = [0]
    for d in range(params.dim):
        offs = [o + dd * st[d] for o in offs
                for dd in range(-hws[d], hws[d] + 1)]
    return tuple(sorted(offs))


def cell_id(pos: torch.Tensor, params: SimParams) -> torch.Tensor:
    """(N, d) positions -> (N,) int32 linear padded cell ids (interior).

    Bit for bit the reference's float32 ``floor((pos - lo) * (1 / cell))``,
    cast, clipped to the grid, shifted by the ghost ring: a Python scalar
    enters a float32 op rounded to float32, as in JAX.
    """
    lo = params.bounds_min
    cax = params.cells_axis
    hws = halfwidths(params)
    res = params.grid_res
    st = strides(params)
    cid = torch.zeros(pos.shape[:-1], dtype=torch.int32, device=pos.device)
    for d in range(params.dim):
        c = torch.floor((pos[..., d] - lo[d]) * (1.0 / cax[d])).to(
            torch.int32)
        c = torch.clamp(c, 0, res[d] - 1) + hws[d]
        cid = cid + c * st[d]
    return cid


class CellTable(NamedTuple):
    """Dense fixed-capacity cell table; C = num_padded_cells, K =
    cell_capacity."""

    pos: torch.Tensor        # (C, K, d) SENTINEL where empty
    vel: torch.Tensor        # (C, K, d) 0 where empty
    slot: torch.Tensor       # (N,) int32 slot in C * K; -1 if dropped
    valid: torch.Tensor      # (C, K) bool
    overflow: torch.Tensor   # () int32 dropped (rank >= K) particles


def build_cell_table(pos: torch.Tensor, vel: torch.Tensor,
                     params: SimParams) -> CellTable:
    n, dim = pos.shape
    k = params.cell_capacity
    c = num_padded_cells(params)
    dev = pos.device

    cid = cell_id(pos, params)
    order = torch.argsort(cid, stable=True)
    cid_sorted = cid[order]
    first = torch.searchsorted(cid_sorted, cid_sorted, side="left")
    rank = torch.arange(n, dtype=torch.int32, device=dev) \
        - first.to(torch.int32)
    ok = rank < k
    overflow = torch.sum(~ok).to(torch.int32)

    # dropped rows write row c * k, one past the table, which is cut off
    # (the reference's scatter mode="drop")
    slot_sorted = torch.where(ok, cid_sorted * k + rank, c * k)
    idx = slot_sorted.to(torch.int64)
    flat_pos = torch.full((c * k + 1, dim), SENTINEL, dtype=pos.dtype,
                          device=dev)
    flat_pos[idx] = pos[order]
    flat_vel = torch.zeros((c * k + 1, dim), dtype=vel.dtype, device=dev)
    flat_vel[idx] = vel[order]
    valid = torch.zeros((c * k + 1,), dtype=torch.bool, device=dev)
    valid[idx] = True

    slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    slot[order] = torch.where(ok, slot_sorted, -1).to(torch.int32)

    return CellTable(pos=flat_pos[:-1].reshape(c, k, dim),
                     vel=flat_vel[:-1].reshape(c, k, dim),
                     slot=slot, valid=valid[:-1].reshape(c, k),
                     overflow=overflow)


def gather_per_particle(dense_field: torch.Tensor, slot: torch.Tensor,
                        fill: float) -> torch.Tensor:
    """(C, K, ...) per-slot values -> (N, ...) per original particle;
    dropped particles (slot -1) get ``fill``."""
    flat = dense_field.reshape((-1,) + tuple(dense_field.shape[2:]))
    out = flat[torch.clamp_min(slot, 0).to(torch.int64)]
    keep = (slot >= 0).reshape((-1,) + (1,) * (out.ndim - 1))
    return torch.where(keep, out, fill)
