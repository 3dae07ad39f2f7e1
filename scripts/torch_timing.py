"""Timing helpers of the kernel probes (scripts/torch_probe_*.py) on a CUDA
card: CUDA events around a run of calls, torch.profiler's device time by
kernel, the device time with L2 flushed before each call, and the card's
name and power limit to print beside every number.  Imports nothing of JAX;
``torch`` is passed in, so importing this module needs no card.
"""

from __future__ import annotations

import subprocess

# profiler sessions a device time may take: a session now and then records
# no device activity at all (seen on the H100), so an empty one is retried
PROFILE_TRIES = 3
FLUSH_BYTES = 128 << 20          # over twice the H100's 50 MB of L2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms(torch, fn, reps: int) -> float:
    """Mean device time of one call, from CUDA events around ``reps`` calls
    after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def kernel_us(torch, fn, reps: int) -> dict:
    """Device time (us) and launches of each kernel, copy and fill that
    ``reps`` calls of ``fn`` launched, by name, summed by torch.profiler
    after two warm-up calls; an empty session is retried."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {e.key: (e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0}
        if out:
            return out
    raise RuntimeError(f"torch.profiler saw no device time in "
                       f"{PROFILE_TRIES} sessions")


def cold_ms(torch, fn, reps: int) -> float:
    """Mean device time of one call with L2 flushed before it: kernel_us
    over ``reps`` pairs of a flush (a bitwise_not_ of a FLUSH_BYTES buffer)
    and a call, less the kernels a flush alone launches."""
    buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    flush_keys = set(kernel_us(torch, buf.bitwise_not_, 3))
    pairs = kernel_us(torch, lambda: (buf.bitwise_not_(), fn()), reps)
    return sum(us for k, (us, _) in pairs.items()
               if k not in flush_keys) / 1e3 / reps
