"""Device milliseconds per step of the mover path (``ops/inc.py``
``compact``, ``arrival_planes``, ``consolidate``), from traced window B's
layers."""

from fbench.trace import device_ms_by


def read(run):
    if run.trace is None:
        return None
    ms = device_ms_by(run.trace.b, "layer").get("mover path")
    return None if ms is None else ms / run.trace.steps_b
