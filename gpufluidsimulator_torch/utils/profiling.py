"""Timing, tracing and operation counts.

Counterpart: ``gpufluidsimulator_tpu/utils/profiling.py``.  ``slope_time``
keeps the reference's contract (seconds per application of a step, the
difference of a long and a short run), timed with CUDA events on the card
and the host clock on the CPU; ``trace`` is a ``torch.profiler`` session
that writes a gzipped Chrome trace (TensorBoard / Perfetto);
``cost_analysis`` counts operations with ``FlopCounterMode``.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Callable, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode


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


def _elementwise(*args, out_shape=None, **kwargs) -> int:
    return math.prod(out_shape)


def _reduction(in_shape, *args, out_shape=None, **kwargs) -> int:
    return math.prod(in_shape)


_ELEMENTWISE = ("add", "sub", "mul", "div", "neg", "abs", "sqrt", "rsqrt",
                "pow", "exp", "clamp", "clamp_min", "clamp_max", "maximum",
                "minimum")
_REDUCTIONS = ("sum", "mean", "amax", "amin")


def cost_analysis(fn: Callable, *args) -> Dict:
    """Operations of one call ``fn(*args)``: ``{"flops": n}``.

    ``FlopCounterMode`` counts the matrix products by PyTorch's own
    formulas; to them this adds one operation per output element of the
    elementwise arithmetic above and one per input element of a sum or
    max, as XLA's cost analysis counts them.  Calls into
    ``_build.library()`` (the hand-written CUDA kernels) are not PyTorch
    operators and are not counted: for those, the bounds that
    ``chip_smoke.py`` prints are the count.
    """
    aten = torch.ops.aten
    mapping = {getattr(aten, name): _elementwise for name in _ELEMENTWISE}
    mapping.update({getattr(aten, name): _reduction for name in _REDUCTIONS})
    counter = FlopCounterMode(display=False, custom_mapping=mapping)
    with counter:
        fn(*args)
    return {"flops": counter.get_total_flops()}


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
