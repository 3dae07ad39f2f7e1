"""A kernel's share of its roofline on one NVIDIA H100 SXM.

Peaks (NVIDIA's H100 SXM data sheet, at the full 700 W power limit): HBM3
at 3.35e12 B/s, and 67e12 FLOP/s of float32 outside the tensor cores (the
sweeps' arithmetic is float32 vector work).  The least time a launch could
take is the larger of its bytes over the first and its operations over the
second; the share is that time over the mean device time of the kernel's
launches in the traced window.  The work of a launch is counted by the
kernel's file under ``rooflines/`` from the particle count and the pairs
within h, never from an implementation's slots or candidate sets.
"""

from __future__ import annotations

import statistics

from . import spec, trace

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def share(run, kernel: str):
    """Percent of the roofline that ``kernel`` reached in the traced
    window A; None without a trace, a launch or a count."""
    if run.trace is None:
        return None
    times = trace.kernel_durations(run.trace.a, kernel)
    count = spec.roofline_count(run.harness, kernel)
    if not times or count is None:
        return None
    nbytes, flops = count(run.n, run.trace.pairs, run.dim)
    return 100.0 * bound_s(nbytes, flops) / statistics.fmean(times)
