"""Particle state and the device rule of the port's entry points.

Counterpart: ``gpufluidsimulator_tpu/models/state.py``.  ``State`` is a
NamedTuple of tensors; the steps map State -> State without mutating it.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card (``cuda``).  Without CUDA that raises: the port
    never falls back to the CPU unless the caller asks for it with
    ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch path on the host")
    return dev


class State(NamedTuple):
    pos: torch.Tensor        # (N, dim) float32
    vel: torch.Tensor        # (N, dim) float32
    rho: torch.Tensor        # (N,)     float32  (last-step density)
    pres: torch.Tensor       # (N,)     float32  (last-step pressure)
    # the pallas path keeps particles cell-sorted; ids maps each row back to
    # its spawn index
    ids: torch.Tensor        # (N,)     int32
    overflow: torch.Tensor   # ()       int32 cell-capacity overflow count

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    @property
    def dim(self) -> int:
        return self.pos.shape[1]

    def to(self, device) -> "State":
        return State(*(t.to(device) for t in self))


def _f32(a, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def make_state(pos, vel=None, device: DeviceLike = None) -> State:
    """Fresh state from positions (and velocities), ids in spawn order."""
    dev = resolve_device(device)
    pos = _f32(pos, dev)
    vel = torch.zeros_like(pos) if vel is None else _f32(vel, dev)
    n = pos.shape[0]
    return State(pos=pos, vel=vel,
                 rho=torch.zeros((n,), dtype=torch.float32, device=dev),
                 pres=torch.zeros((n,), dtype=torch.float32, device=dev),
                 ids=torch.arange(n, dtype=torch.int32, device=dev),
                 overflow=torch.zeros((), dtype=torch.int32, device=dev))
