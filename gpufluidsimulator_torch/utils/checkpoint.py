"""Checkpoint / resume in the reference's ``.npz`` format.

Counterpart: ``gpufluidsimulator_tpu/utils/checkpoint.py``: the same keys,
dtypes and params JSON, so each package loads the other's files.  ``save``
/ ``load`` hold a flat ``State``; ``save_sharded`` / ``load_sharded`` a
``parallel.sharded.ShardedState`` as stacked per-slab arrays (no gather);
``save_planes`` / ``load_planes`` the incremental path's ``IncState``
directly (no planes -> flat conversion), with its ``mig_overflow`` and the
continuity tier's carried ``rhop`` and ``age``; ``rotate`` writes
step-stamped files and keeps the newest few.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import numpy as np
import torch

from ..models.params import SimParams
from ..models.state import DeviceLike, State, resolve_device


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _tensor(a, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dev)


def _params_meta(params: SimParams) -> np.ndarray:
    return np.frombuffer(json.dumps(dataclasses.asdict(params)).encode(),
                         dtype=np.uint8)


def _params_from_meta(buf) -> SimParams:
    meta = json.loads(bytes(buf).decode())
    for key in ("gravity", "bounds_min", "bounds_max", "cell_aniso"):
        meta[key] = tuple(meta.get(key, ()))
    meta["obstacles"] = tuple(
        (o[0], tuple(o[1]), o[2] if isinstance(o[2], (int, float))
         else tuple(o[2])) for o in meta["obstacles"])
    return SimParams(**meta)


def save(path: str, state: State, params: SimParams,
         step: int = 0) -> None:
    """Write state + params (+ step counter) to one .npz file."""
    np.savez_compressed(
        path, **{k: _np(v) for k, v in zip(State._fields, state)},
        step=np.asarray(step, np.int64),
        params_json=_params_meta(params))


def load(path: str, device: DeviceLike = None
         ) -> Tuple[State, SimParams, int]:
    """Load (state, params, step) from an .npz checkpoint onto ``device``
    (default: the card)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        params = _params_from_meta(z["params_json"])
        state = State(*(_tensor(z[k], dev) for k in State._fields))
        return state, params, int(z["step"])


def save_sharded(path: str, sstate, params: SimParams, step: int = 0,
                 n_total: int = 0) -> None:
    """Snapshot a ``parallel.sharded.ShardedState`` without a gather: the
    slabs' arrays stacked (n_slabs, N_cap, ...), as the reference writes
    them.  Every slab must be in this process.  Resume with
    ``load_sharded(path, mesh)`` on a mesh of as many slabs."""
    if any(p is None for p in sstate.pos):
        raise ValueError("save_sharded writes every slab; slabs of other "
                         "processes are not here")

    def stacked(field):
        return np.stack([_np(t) for t in getattr(sstate, field)])

    np.savez_compressed(
        path,
        kind=np.asarray(1, np.int64),
        **{f: stacked(f) for f in ("pos", "vel", "rho", "pres", "ids",
                                   "overflow", "mig_overflow")},
        n_total=np.asarray(n_total, np.int64),
        step=np.asarray(step, np.int64),
        params_json=_params_meta(params))


def load_sharded(path: str, mesh):
    """Load (ShardedState, params, step, n_total) onto a mesh's slabs (this
    process's, each on its device).  Raises ``ValueError`` unless the mesh
    has as many slabs as the file (slabs are per-slab state)."""
    from ..parallel.mesh import shard_leading
    from ..parallel.sharded import ShardedState

    with np.load(path) as z:
        params = _params_from_meta(z["params_json"])
        n_dev = z["pos"].shape[0]
        if mesh.size != n_dev:
            raise ValueError(f"checkpoint has {n_dev} slabs but the mesh "
                             f"has {mesh.size}")
        sstate = ShardedState(**{f: shard_leading(mesh, z[f])
                                 for f in ShardedState._fields})
        return sstate, params, int(z["step"]), int(z["n_total"])


def save_planes(path: str, inc_state, params: SimParams,
                step: int = 0, n: int = 0) -> None:
    """Snapshot an ``ops.inc.IncState`` (the planes-resident carried state)
    directly, so an incremental run resumes bitwise.  The continuity
    tier's ``rhop`` and ``age`` (an int32 scalar in the file) ride along
    when present."""
    extra = {}
    if inc_state.rhop is not None:
        extra = dict(rhop=_np(inc_state.rhop),
                     age=np.asarray(inc_state.age, np.int32))
    np.savez_compressed(
        path,
        kind=np.asarray(2, np.int64),
        fields6=_np(inc_state.fields6),
        idp=_np(inc_state.idp),
        overflow=_np(inc_state.overflow),
        mig_overflow=_np(inc_state.mig_overflow),
        n=np.asarray(n, np.int64),
        step=np.asarray(step, np.int64),
        params_json=_params_meta(params), **extra)


def load_planes(path: str, device: DeviceLike = None):
    """Load (IncState, params, step, n) from a planes checkpoint onto
    ``device`` (default: the card)."""
    from ..ops.inc import IncState

    dev = resolve_device(device)
    with np.load(path) as z:
        params = _params_from_meta(z["params_json"])
        # absent in the reference's oldest checkpoints: 0
        mig = (z["mig_overflow"] if "mig_overflow" in z
               else np.asarray(0, np.int32))
        state = IncState(fields6=_tensor(z["fields6"], dev),
                         idp=_tensor(z["idp"], dev),
                         overflow=_tensor(z["overflow"], dev),
                         mig_overflow=_tensor(mig, dev),
                         rhop=(_tensor(z["rhop"], dev) if "rhop" in z
                               else None),
                         age=int(z["age"]) if "age" in z else None)
        return state, params, int(z["step"]), int(z["n"])


def rotate(directory: str, state: State, params: SimParams, step: int,
           keep: int = 3) -> str:
    """Write a step-stamped checkpoint and prune old ones (keep newest N)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:09d}.npz")
    save(path, state, params, step)
    ckpts = sorted(f for f in os.listdir(directory)
                   if f.startswith("ckpt_") and f.endswith(".npz"))
    for old in ckpts[:-keep]:
        os.remove(os.path.join(directory, old))
    return path


def latest(directory: str):
    """Path of the newest checkpoint in a directory, or None."""
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(f for f in os.listdir(directory)
                   if f.startswith("ckpt_") and f.endswith(".npz"))
    return os.path.join(directory, ckpts[-1]) if ckpts else None
