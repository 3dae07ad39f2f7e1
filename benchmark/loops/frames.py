"""A viewer's loop: episodes of ``frames_per_episode`` frames, each from
the evolved state; a frame is ``FluidSim.step(steps_per_frame)``, then
``render.render_frame`` and the image on the host (``render.tonemap``).

Traffic keys: ``method``, ``steps_per_frame``, ``frames_per_episode``,
``warm_frames``, ``width``, ``height``, ``color_by``, ``azimuth``,
``elevation``, ``check_steps``, ``checked_frames``, ``returned_rho``,
``trace_a``, ``trace_b`` and ``trace_c`` (frames in traced windows A, B
and C).  The run record gets ``frame_latency`` (each frame's seconds,
from its start to its image on the host) and, traced, ``trace.render_ms``.
"""

from __future__ import annotations

import statistics
import time
from types import SimpleNamespace

import numpy as np
import torch

from fbench import check, scene, trace
from fbench.bench import Comparison
from fbench.reference import splat, tonemap


def frames(c, count, deadline, keep=(), sync_render=False):
    """Frames until ``deadline`` or ``count`` frames -> a record with
    each frame's latency and render span (s), the failed count and the
    kept frames {index: (state in, state out, fb, img)}: those in
    ``keep`` and, when ``keep`` is given, the last."""
    fs = c.prog.solver.FluidSim
    render = c.prog.render
    t = c.t
    out = SimpleNamespace(latency=[], render=[], kept={}, last=None,
                          failed=torch.zeros((), dtype=torch.long,
                                             device=c.dev))
    idx = 0
    while True:
        sim = fs(c.params, c.evolved, method=t["method"], device=c.dev)
        for _ in range(t["frames_per_episode"]):
            t0 = time.perf_counter()
            before = sim.state
            with torch.profiler.record_function("bench.frame.step"):
                after = sim.step(t["steps_per_frame"])
            if sync_render:
                c.sync()
            t1 = time.perf_counter()
            with torch.profiler.record_function("bench.frame.render"):
                fb = render.render_frame(after, c.params, width=t["width"],
                                         height=t["height"],
                                         color_by=t["color_by"],
                                         azimuth=t["azimuth"],
                                         elevation=t["elevation"])
                img = render.tonemap(fb)
            t2 = time.perf_counter()
            out.latency.append(t2 - t0)
            out.render.append(t2 - t1)
            out.failed += c.guard(after)
            out.last = after
            if idx in keep:
                out.kept[idx] = (before, after, fb, img)
            idx += 1
            if (count is not None and idx >= count) or (
                    deadline is not None and t2 >= deadline):
                if keep:      # the window's last frame is checked too
                    out.kept[idx - 1] = (before, after, fb, img)
                return out


def sample_frames(c):
    """The frames the check follows, drawn from the seed."""
    rng = np.random.default_rng(int(c.seed) % scene.SEED_MOD)
    return set(int(i) for i in rng.choice(c.t["frames_per_episode"],
                                          size=c.t["checked_frames"],
                                          replace=False))


def warm(c):
    frames(c, c.t["warm_frames"], None)


def _keep(rec, fr):
    rec.failed, rec.kept, rec.last = fr.failed, fr.kept, fr.last


def window(c, rec, seconds):
    t0 = time.perf_counter()
    fr = frames(c, None, t0 + seconds, sample_frames(c))
    rec.window_s = time.perf_counter() - t0
    rec.frame_latency = fr.latency
    rec.attempted = len(fr.latency)
    _keep(rec, fr)


def traced(c, rec, tables):
    """Window A (the profiler, no stacks) for the device's busy time and
    the breakdown; window B (with Python stacks) for each device
    operation's layer; window C (no profiler; a wait for the card between
    the steps and the frame) for the render span."""
    t = c.t
    n_a, n_b, n_c = t["trace_a"], t["trace_b"], t["trace_c"]
    box = {}
    cuda = c.dev.type == "cuda"
    a = trace.profile(lambda: box.update(
        a=frames(c, n_a, None, sample_frames(c))), tables, False, cuda)
    rec.peak_bytes = c.peak()
    b = trace.profile(lambda: box.update(b=frames(c, n_b, None)), tables,
                      True, cuda)
    span = frames(c, n_c, None, sync_render=True)
    _keep(rec, box["a"])
    rec.failed = rec.failed + box["b"].failed + span.failed
    rec.attempted = n_a + n_b + n_c
    steps = t["steps_per_frame"]
    rec.trace = SimpleNamespace(a=a, b=b, steps_a=n_a * steps,
                                steps_b=n_b * steps,
                                render_ms=statistics.fmean(span.render) * 1e3)
    rec.window_s = a.window_s


def one(c, rec):
    _keep(rec, frames(c, c.t["frames_per_episode"], None, sample_frames(c)))


def render_ref(c, state, fb, dtype=torch.float64):
    """The reference's splat of ``state`` and its tonemap of the
    program's framebuffer ``fb`` (in float32 for a control)."""
    t = c.t
    rfb = splat(state.pos, state.vel, c.const.bounds_min,
                c.const.bounds_max, t["width"], t["height"], t["azimuth"],
                t["elevation"], dtype)
    img = tonemap(fb.double().cpu().numpy(),
                  np.float64 if dtype == torch.float64 else np.float32)
    return rfb, img


def comparisons(c, rec, dtype):
    """Each kept frame: its steps from the frame's own input, its
    framebuffer and its image."""
    for idx in sorted(rec.kept):
        before, after, fb, img = rec.kept[idx]
        ref = c.reference(before, dtype)
        nums = c.gaps(after, ref)
        rfb, rimg = render_ref(c, after, fb, dtype)
        nums.update(check.frame_gaps(fb, img, rfb, rimg))
        yield Comparison(before, after, ref, (fb, img, rfb, rimg), nums)


def extra_readings(c, cmp, seed):
    """Calibration's frame readings: the control's splat and tonemap, an
    image with one pixel moved by 64 levels, and the frame as it is for
    the faults of the states."""
    fb, img, rfb, rimg = cmp.extra
    cfb, cimg = render_ref(c, cmp.prog, fb, torch.bfloat16)
    bad = img.copy()
    bad[img.shape[0] // 2, img.shape[1] // 2, 0] ^= np.uint8(64)
    same = check.frame_gaps(fb, img, rfb, rimg)
    return {"control": check.frame_gaps(cfb, cimg, rfb, rimg),
            "altered": check.frame_gaps(fb, bad, rfb, rimg),
            "unchanged": same, "half": dict(same)}
