"""Reading a profiler trace: the busy union, the layer of each device
operation (launchers, outermost claim, else innermost; else the kernel's
name), and the idle gaps named by the host's activity."""

from __future__ import annotations

from fbench import trace
from fbench.spec import tables
from conftest import HARNESS

INC = "gpufluidsimulator_torch/ops/inc.py"


def fn(ts, dur, name):
    return {"cat": "python_function", "ts": ts, "dur": dur, "name": name}


def kernel(ts, dur, name, corr):
    return {"cat": "kernel", "ts": ts, "dur": dur, "name": name,
            "args": {"correlation": corr}}


def launch(ts, corr):
    return {"cat": "cuda_runtime", "ts": ts, "dur": 1.0,
            "name": "cudaLaunchKernel", "args": {"correlation": corr}}


def test_layers_busy_and_gaps():
    t = tables(HARNESS)
    ev = [
        fn(0, 100, f"{INC}(575): run_inc"),
        fn(5, 30, f"{INC}(404): step_planes"),
        fn(6, 20, f"{INC}(421): step_phases"),
        fn(7, 5, f"{INC}(164): compact"),
        fn(40, 30, f"{INC}(371): to_flat"),
        fn(45, 10, f"{INC}(164): compact"),
        launch(8, 1), kernel(50, 10, "void compact_kernel(float*)", 1),
        launch(46, 2), kernel(70, 5, "void compact_kernel(float*)", 2),
        launch(20, 3), kernel(80, 10, "void cub::DeviceRadixSortOnesweep"
                              "Kernel<int>(int*)", 3),
        kernel(90, 4, "void force_kernel<8, 3, true, 0>(float const*)", 4),
        {"cat": "user_annotation", "ts": 55, "dur": 20, "name": "bench.call"},
    ]
    r = trace.read_events(ev, t, window_s=100e-6)
    layers = [(o.kernel, o.layer) for o in r.ops]
    assert layers == [("compact", "mover path"), ("compact", "conversion"),
                      (None, "step"), ("force_step", "kernels")]
    assert abs(r.busy_s - 29e-6) < 1e-12
    assert abs(sum(r.gaps.values()) - 15e-6) < 1e-12
    assert "bench.call/python" in r.gaps
    b = trace.breakdown(r)
    assert b["device_ops"][0][0] in ("compact", "void cub::DeviceRadixSort"
                                     "OnesweepKernel<int>")
    assert trace.kernel_durations(r, "force_step") == [4e-6]
