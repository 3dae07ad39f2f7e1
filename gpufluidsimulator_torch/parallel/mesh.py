"""The 1D slab mesh: which device holds each x slab, and the exchanges
between neighbouring slabs.

Counterpart: ``gpufluidsimulator_tpu/parallel/mesh.py``.  The reference's
mesh is a ``jax.sharding.Mesh`` over devices, each running one program in
which ``ppermute`` is a collective.  Here a ``Mesh`` lists, for each slab,
its ``torch.device`` and the rank of the process that owns it.  A process
steps its own slabs in lock step (``lockstep``): each slab's step is a
generator that yields at every exchange, and the exchange runs over all of
the process's slabs at once.

  * Between two slabs of one process, an exchange is a copy from tensor to
    tensor (``Tensor.to`` the receiver's device, which may be the same
    one: a mesh may repeat a device, the counterpart of the reference's
    virtual devices).
  * Between two processes it is one ``torch.distributed`` P2P batch
    (``batch_isend_irecv``): gloo for a CPU mesh, NCCL for a mesh with one
    card per process.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

AXIS = "x"


class Mesh(NamedTuple):
    """A 1D mesh of x slabs: slab d lives on ``devices[d]`` in process
    ``ranks[d]``; ``rank`` is this process's."""
    devices: Tuple[torch.device, ...]
    ranks: Tuple[int, ...]
    rank: int = 0

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> Tuple[int, ...]:
        """The slabs this process owns, in slab order."""
        return tuple(d for d, r in enumerate(self.ranks) if r == self.rank)


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None) -> bool:
    """Multi-process entry point: join the process group.

    Arguments default to the environment, as the reference's do:

      FLUID_COORDINATOR   host:port of process 0's rendezvous
      FLUID_NUM_PROCESSES total process count
      FLUID_PROCESS_ID    this process's rank

    ``device`` is the kind of mesh the processes form: the card (the
    default; NCCL, one card per process, this process's being
    ``cuda:<rank % cards>``) or ``"cpu"`` (gloo).  Returns True when the
    group was joined, False for the single-process no-op, so callers can
    do ``init_distributed(); mesh = make_mesh()`` unconditionally."""
    from ..models.state import resolve_device

    if coordinator_address is None:
        coordinator_address = os.environ.get("FLUID_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("FLUID_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("FLUID_PROCESS_ID", "0"))
    if num_processes <= 1 or coordinator_address is None:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    torch.distributed.init_process_group(
        _backend(dev), init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return True


def _distributed() -> bool:
    return torch.distributed.is_available() \
        and torch.distributed.is_initialized()


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1D mesh of slabs.

    One process: ``devices`` lists each slab's device and may repeat one
    (``[cuda:0] * 8`` puts eight slabs on one card); by default one slab
    per visible card, the first ``n_devices`` of them.

    Several processes (after ``init_distributed``): ``devices`` lists THIS
    process's slabs, the same count in every process; by default one slab
    on the process's card (NCCL) or on the CPU (gloo).  The global mesh is
    every process's slabs in rank order.  A CUDA slab under gloo, a CPU
    slab under NCCL, and two processes on one card are refused."""
    if devices is None:
        if _distributed() and torch.distributed.get_backend() == "gloo":
            devices = [torch.device("cpu")]
        elif _distributed():
            devices = [torch.device("cuda", torch.cuda.current_device())]
        else:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CUDA is not available; pass devices=['cpu', ...] for "
                    "a mesh of slabs on the host")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
            if n_devices is not None:
                devices = devices[:n_devices]
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one slab")
    if not _distributed():
        return Mesh(devices=tuple(devices), ranks=(0,) * len(devices))
    dist = torch.distributed
    backend = dist.get_backend()
    want = "cpu" if backend == "gloo" else "cuda"
    for d in devices:
        if d.type != want:
            raise ValueError(f"a {backend} process group takes {want} "
                             f"slabs, got {d}")
    me, world = dist.get_rank(), dist.get_world_size()
    mine = [(str(d), _card_id(d)) for d in devices]
    every = [None] * world
    dist.all_gather_object(every, mine)
    if len({len(e) for e in every}) != 1:
        raise ValueError(f"processes hold different slab counts: "
                         f"{[len(e) for e in every]}")
    if backend == "nccl":
        cards = [c for e in every for _, c in set(e)]
        if len(cards) != len(set(cards)):
            raise ValueError("two processes hold one card; NCCL needs one "
                             "card per process")
    return Mesh(devices=tuple(torch.device(s) for e in every for s, _ in e),
                ranks=tuple(r for r, e in enumerate(every) for _ in e),
                rank=me)


def _card_id(d: torch.device):
    """A card's identity across the processes of one host (its UUID)."""
    if d.type != "cuda":
        return None
    return str(torch.cuda.get_device_properties(d).uuid)


def shard_leading(mesh: Mesh, array) -> Tuple[Optional[torch.Tensor], ...]:
    """Split the leading (slab) axis of a stacked array over the mesh:
    entry d is slab d's part on its device, or None where another process
    owns slab d."""
    return tuple(
        torch.as_tensor(np.asarray(array[d])).to(mesh.devices[d])
        if r == mesh.rank else None
        for d, r in enumerate(mesh.ranks))


def shift_pair(mesh: Mesh, to_right: Dict[int, torch.Tensor],
               to_left: Dict[int, torch.Tensor]):
    """The counterpart of the reference's pair of ``ppermute``s: slab d
    sends ``to_right[d]`` to slab d + 1 and ``to_left[d]`` to slab d - 1.
    Returns (from_left, from_right): for each slab of this process what
    its left / right neighbour sent, None at the mesh's edges.  The dicts
    hold this process's slabs.  Tensors of one direction share one shape,
    as every slab's arrays do."""
    local = set(to_right)
    from_left: Dict[int, Optional[torch.Tensor]] = {}
    from_right: Dict[int, Optional[torch.Tensor]] = {}
    ops = []
    for d in sorted(local):
        for src, shift, got in ((d - 1, 1, from_left),
                                (d + 1, -1, from_right)):
            if not 0 <= src < mesh.size:
                got[d] = None
            elif src in local:
                sent = (to_right if shift == 1 else to_left)[src]
                got[d] = sent.to(to_right[d].device)
            else:
                like = (to_right if shift == 1 else to_left)[d]
                got[d] = torch.empty_like(like)
                ops.append(torch.distributed.P2POp(
                    torch.distributed.irecv, got[d], mesh.ranks[src]))
        for dst, sent in ((d + 1, to_right[d]), (d - 1, to_left[d])):
            if 0 <= dst < mesh.size and mesh.ranks[dst] != mesh.rank:
                ops.append(torch.distributed.P2POp(
                    torch.distributed.isend, sent.contiguous(),
                    mesh.ranks[dst]))
    if ops:
        for req in torch.distributed.batch_isend_irecv(ops):
            req.wait()
    return from_left, from_right


def lockstep(steps: Dict[int, object]) -> Dict[int, object]:
    """Run one step of each of this process's slabs in lock step.

    ``steps[d]`` is slab d's step as a generator: it yields
    ``(exchange, payload)`` at each exchange point and takes back its
    share of the exchange's result; it returns its new state.  Every slab
    reaches the same exchanges in the same order, so at each point the
    exchange runs once, over all the slabs' payloads: ``exchange(payloads:
    dict) -> dict``.  Returns each slab's new state."""
    out = {}
    msgs = {}
    for d, g in steps.items():
        try:
            msgs[d] = next(g)
        except StopIteration as stop:
            out[d] = stop.value
    while msgs:
        if out:
            raise RuntimeError("slabs of one mesh left their step at "
                               "different exchanges")
        exchange = next(iter(msgs.values()))[0]
        replies = exchange({d: payload for d, (_, payload) in msgs.items()})
        done = {}
        nxt = {}
        for d in msgs:
            try:
                nxt[d] = steps[d].send(replies[d])
            except StopIteration as stop:
                done[d] = stop.value
        if done and nxt:
            raise RuntimeError("slabs of one mesh left their step at "
                               "different exchanges")
        out.update(done)
        msgs = nxt
    return out

