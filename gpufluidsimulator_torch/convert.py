"""Carry parameters, states and plane tables over from the JAX package.

Takes only Python scalars and numpy arrays (never JAX objects), so the port
stays free of JAX: a caller converts with ``dataclasses.asdict`` and
``np.asarray`` on its side and hands the results here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .models.params import SimParams
from .models.state import DeviceLike, State, resolve_device


def _tuples(v):
    if isinstance(v, (list, tuple)):
        return tuple(_tuples(x) for x in v)
    return v


def params_from_dict(d: dict) -> SimParams:
    """SimParams from the reference's fields (``dataclasses.asdict``)."""
    return SimParams(**{k: _tuples(v) for k, v in d.items()})


def state_from_numpy(pos, vel, rho, pres, ids, overflow,
                     device: DeviceLike = None) -> State:
    """State from numpy arrays of the reference's State fields."""
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    return State(pos=t(pos, torch.float32), vel=t(vel, torch.float32),
                 rho=t(rho, torch.float32), pres=t(pres, torch.float32),
                 ids=t(ids, torch.int32),
                 overflow=t(overflow, torch.int32).reshape(()))


class PlaneInputs(NamedTuple):
    planes: torch.Tensor      # (6, K, pz, n_bx, py, 128) f32
    slot: torch.Tensor        # (N,) int32
    ok: torch.Tensor          # (N,) bool
    occ_q: torch.Tensor       # int32 block bounds
    occ_s: torch.Tensor       # int32 stencil bounds


def planes_from_numpy(planes, slot, ok, occ_q, occ_s,
                      device: DeviceLike = None) -> PlaneInputs:
    """The port's tensors from a reference PlaneTable's planes, slot and ok
    and its occupancy bounds (as numpy)."""
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    return PlaneInputs(planes=t(planes, torch.float32),
                       slot=t(slot, torch.int32), ok=t(ok, torch.bool),
                       occ_q=t(occ_q, torch.int32),
                       occ_s=t(occ_s, torch.int32))


def inc_state_from_numpy(fields6, idp, overflow, device: DeviceLike = None,
                         rhop=None, age=None, mig_overflow=0):
    """The incremental path's carried state from a reference IncState's
    fields6, idp, overflow and mig_overflow (as numpy), and on the
    continuity tier its rhop (numpy) and age (any integer scalar; the port
    carries a host int)."""
    from .ops.inc import IncState
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    return IncState(fields6=t(fields6, torch.float32),
                    idp=t(idp, torch.float32),
                    overflow=t(overflow, torch.int32).reshape(()),
                    mig_overflow=t(mig_overflow, torch.int32).reshape(()),
                    rhop=None if rhop is None else t(rhop, torch.float32),
                    age=None if age is None else int(age))
