"""Timing, tracing, and the program's record of its own calls.

Counterpart: ``gpufluidsimulator_tpu/utils/profiling.py``.  ``slope_time``
keeps the reference's contract (seconds per application of a step, the
difference of a long and a short run), timed with CUDA events on the card
and the host clock on the CPU; ``trace`` is a ``torch.profiler`` session
that writes a gzipped Chrome trace (TensorBoard / Perfetto).

Spans and counters (``span``, ``tally``) exist only while a profiler
session records.  Without one a span is one flag test and a shared null
context, and a tally does nothing.  While one records, a span is a
``record_function`` range (a ``user_annotation`` on the profiler's
timeline, beside the card's kernels) and adds its host time and self time
(its time less its child spans') to the record of the current call: the
outermost open span.  Tallies add device integer counts to that call;
they stay on the device until the record is read (``calls``,
``take_calls``), which synchronises once per device.

Spans of the port, by layer: ``solver.run`` / ``solver.rollout`` /
``sharded.run`` (entry: one call); ``inc.to_planes`` / ``inc.to_flat``
(conversion); ``inc.step``, ``pallas.step``, ``naive.step``,
``gridded.step`` (a step; a sharded step's spans its lock step); the
phases of an incremental step ``inc.bounds``, ``inc.density``,
``inc.force``, ``inc.compact``, ``inc.consolidate``, and of a full
rebuild ``pallas.binning``, ``pallas.density``, ``pallas.force``,
``pallas.gather``; ``sharded.exchange``; ``render.splat``,
``render.tonemap``.  Counters: ``movers`` (rows ``compact`` keeps),
``flagged`` (slots it found flagged), ``drops_cell_capacity`` (a
binning's and ``consolidate``'s drops), ``force_ring_overflows`` and
``density_ring_overflows`` (the force kernels' and the density sweep's
staged planes past their ring's capacity, ``sph.RING_OVERFLOWS`` and
``sph.DENSITY_RING_OVERFLOWS``), ``force_fill_skipped`` and
``force_fill_sectors`` (the sectors of 8 lanes of a rank row that the
fused force steps' fill left unwritten, holding no query, and those it
visited: ``sph.FILL_SKIPPED``, ``sph.FILL_SECTORS``), ``seam_movers`` (the
movers whose arrival cell lies in another x tile than the slot they left,
``inc.seam_movers``; 0 on planes of one tile), ``cell_fill_max`` (the
largest count of particles any cell holds after a step's consolidation,
raised by ``consolidate``'s kernel itself); ``drops_mover_capacity``
is ``flagged - movers``.  A counter of ``MAX_COUNTERS`` keeps the largest
of its tallies, every other their sum.  A call also holds its steps (the
count of its step spans) and its launches of each hand-written kernel
(``_build.launches``).
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Dict, List

import torch
from torch.autograd import profiler as _autograd_profiler

from .. import _build


def _device(state) -> torch.device:
    """The device of the first tensor field of a NamedTuple state."""
    for leaf in state:
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    raise ValueError("the state holds no tensor")


def slope_time(step_fn: Callable, init_state, k1: int = 2, k2: int = 12,
               reps: int = 3) -> float:
    """Seconds per application of ``step_fn`` (state -> state).

    Each of a ``k1``-long and a ``k2``-long run from ``init_state`` is run
    once to warm up and then timed ``reps`` times; the result is the
    difference of their mean times over ``k2 - k1``.  On the card each
    timed run lies between two CUDA events and ends in one synchronise; on
    the CPU the host clock times it.  The difference cancels what every
    run pays once (the reference differences away its host round trip;
    here it keeps the numbers of ``bench`` meaning what they meant).

    The reference pulls one element of every leaf so that XLA cannot drop
    work whose result no output reads; eager PyTorch runs every op it is
    given, so nothing is pulled here.
    """
    cuda = _device(init_state).type == "cuda"

    def run(k):
        s = init_state
        for _ in range(k):
            s = step_fn(s)
        return s

    def mean_seconds(k):
        run(k)                                    # warm: builds, caches
        total = 0.0
        for _ in range(reps):
            if cuda:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                run(k)
                t1.record()
                torch.cuda.synchronize()
                total += t0.elapsed_time(t1) / 1e3
            else:
                w0 = time.perf_counter()
                run(k)
                total += time.perf_counter() - w0
        return total / reps

    t1, t2 = mean_seconds(k1), mean_seconds(k2)
    return max((t2 - t1) / (k2 - k1), 1e-12)


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` session (CPU, and CUDA where there is a card)
    that writes a gzipped Chrome trace (``*.pt.trace.json.gz``) into
    ``logdir`` when it ends."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir,
                                                          use_gzip=True)):
        yield


# ---------------------------------------------------------------------------
# spans, counters and the record of calls
# ---------------------------------------------------------------------------

STEP_SPANS = ("inc.step", "pallas.step", "naive.step", "gridded.step")
MAX_CALLS = 4096       # calls the record keeps, the newest
FOLD_EVERY = 256       # tallies a call keeps per device before it adds
#                        them up (three device ops)
_NULL = contextlib.nullcontext()
MAX_COUNTERS = frozenset({"cell_fill_max"})   # kept as a maximum, not a sum


class _Call:
    """One call being recorded: span totals (count, host ns, self ns),
    tallies on the device, and the launch counts when it began."""

    def __init__(self, name: str):
        self.name = name
        self.spans: Dict[str, List[int]] = {}
        self.pending: Dict[tuple, list] = {}   # (keys, device) -> tallies
        self.totals: Dict[tuple, torch.Tensor] = {}   # ... -> int64 sums
        self.counters: Dict[str, int] = {}
        self.launches = dict(_build.launches)

    def tally(self, keys: tuple, values):
        v = torch.stack(values)
        k = (keys, v.device)
        pending = self.pending.setdefault(k, [])
        pending.append(v)
        if len(pending) >= FOLD_EVERY:
            self._fold(k)

    def _fold(self, k):
        keys = k[0]
        v = torch.stack(self.pending.pop(k)).to(torch.int64)
        if k in self.totals:
            v = torch.cat([v, self.totals[k][None]])
        s = v.sum(0)
        for i, key in enumerate(keys):
            if key in MAX_COUNTERS:
                s[i] = v[:, i].amax()
        self.totals[k] = s

    def close(self):
        self.launches = {name: n - self.launches.get(name, 0)
                         for name, n in _build.launches.items()
                         if n != self.launches.get(name, 0)}

    def entry(self) -> dict:
        spans = {name: {"count": c, "host_s": t / 1e9, "self_s": own / 1e9}
                 for name, (c, t, own) in self.spans.items()}
        counters = dict(self.counters)
        if "flagged" in counters:
            counters["drops_mover_capacity"] = (counters["flagged"]
                                                - counters.get("movers", 0))
        return {"name": self.name,
                "steps": sum(self.spans[n][0] for n in STEP_SPANS
                             if n in self.spans),
                "spans": spans, "counters": counters,
                "launches": dict(self.launches)}


class _Record:
    def __init__(self):
        self.calls: collections.deque = collections.deque(maxlen=MAX_CALLS)
        self.stack: list = []
        self.current = None


_RECORD = _Record()


class _Span:
    __slots__ = ("name", "rf", "tot", "t0", "child_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        rec = _RECORD
        if not rec.stack:
            rec.current = _Call(self.name)
        self.tot = rec.current.spans.setdefault(self.name, [0, 0, 0])
        rec.stack.append(self)
        self.child_ns = 0
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        rec = _RECORD
        stack = rec.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += dur
        self.tot[0] += 1
        self.tot[1] += dur
        self.tot[2] += dur - self.child_ns
        if not stack:
            rec.current.close()
            rec.calls.append(rec.current)
            rec.current = None
        self.rf.__exit__(*exc)
        return False


def recording() -> bool:
    """Whether a profiler session records (spans and tallies are live)."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A context for one phase of the program: the shared null context
    when no profiler session records, else a ``record_function`` range
    whose host time goes to the current call (the module docstring).  No
    span may stay open across a generator's ``yield``."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def tally(keys: tuple, *values: torch.Tensor) -> None:
    """Add the () integer device tensors ``values`` to the current call's
    counters named ``keys``: one small device op (a stack), none when no
    profiler session records or no call is open.  Never waits for the
    device."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    call = _RECORD.current
    if call is not None:
        call.tally(keys, values)


def _read_counters(pending_calls) -> None:
    """Move the device tallies of ``pending_calls`` into their host
    ``counters``: one copy to the host per device."""
    by_device: Dict[torch.device, list] = {}
    for call in pending_calls:
        for k in list(call.pending):
            call._fold(k)
        for (keys, dev), t in call.totals.items():
            by_device.setdefault(dev, []).append((call, keys, t))
    for items in by_device.values():
        flat = torch.cat([t for _, _, t in items]).tolist()
        i = 0
        for call, keys, _ in items:
            for key in keys:
                old = call.counters.get(key)
                call.counters[key] = flat[i] if old is None else (
                    max(old, flat[i]) if key in MAX_COUNTERS
                    else old + flat[i])
                i += 1
    for call in pending_calls:
        call.totals.clear()


def calls() -> List[dict]:
    """The record, oldest call first: per call its ``name`` (the outermost
    span), ``steps``, ``spans`` ({name: {count, host_s, self_s}}),
    ``counters`` and ``launches`` ({kernel: launches}).  Reads the device
    counters (synchronising once per device) and keeps the record."""
    _read_counters([c for c in _RECORD.calls if c.pending or c.totals])
    return [c.entry() for c in _RECORD.calls]


def take_calls() -> List[dict]:
    """``calls()``, then clears the record."""
    out = calls()
    _RECORD.calls.clear()
    return out


def format_calls(entries: List[dict]) -> List[str]:
    """Lines of text for ``calls()``' entries: per call each span's count,
    host ms and self ms, the movers a step (and those across an x tile
    seam), the drops by cause, the fullest cell, the force kernels' and the
    density sweep's ring overflows, the sectors the force steps' fill
    skipped and the launches by kernel."""
    lines = []
    for i, e in enumerate(entries):
        lines.append(f"call {i}: {e['name']}, {e['steps']} steps")
        for name, sp in e["spans"].items():
            lines.append(f"  {name:18s} count {sp['count']:7d}  "
                         f"host {sp['host_s'] * 1e3:10.3f} ms  "
                         f"self {sp['self_s'] * 1e3:10.3f} ms")
        c = e["counters"]
        if "movers" in c and e["steps"]:
            seam = (f" ({c['seam_movers'] / e['steps']:.1f} across an x "
                    f"tile seam)" if "seam_movers" in c else "")
            lines.append(f"  movers a step {c['movers'] / e['steps']:.1f}"
                         + seam)
        drops = {k[len("drops_"):]: v for k, v in c.items()
                 if k.startswith("drops_")}
        if drops:
            lines.append("  drops: " + ", ".join(
                f"{k.replace('_', ' ')} {v}"
                for k, v in sorted(drops.items())))
        for sweep in ("force", "density"):
            if f"{sweep}_ring_overflows" in c:
                lines.append(f"  {sweep} ring overflows "
                             f"{c[f'{sweep}_ring_overflows']}")
        if "cell_fill_max" in c:
            lines.append(f"  fullest cell {c['cell_fill_max']} particles")
        if "force_fill_sectors" in c:
            skipped, seen = c["force_fill_skipped"], c["force_fill_sectors"]
            share = f" ({100.0 * skipped / seen:.2f}%)" if seen else ""
            lines.append(f"  force fill skipped {skipped} of {seen} "
                         f"sectors{share}")
        if e["launches"]:
            lines.append("  launches: " + ", ".join(
                f"{k} {v}" for k, v in sorted(e["launches"].items())))
    return lines
