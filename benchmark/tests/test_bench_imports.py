"""What ``benchmark/run.py`` loads holds no module whose top-level name
is jax, jaxlib or gpufluidsimulator_tpu (compared whole: the port's name
begins with the JAX package's); the reference loads nothing of the port
either."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import HARNESS, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "gpufluidsimulator_tpu"}


def loaded(code: str):
    p = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": "",
             "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_run_loads_nothing_of_jax():
    tops = loaded(
        f"import sys; sys.path.insert(0, {str(HARNESS)!r})\n"
        "import runpy; runpy.run_path('benchmark/run.py', run_name='x')\n"
        "from fbench import bench, check, program, reference, roofline, "
        "scene, spec, trace\n"
        "from pathlib import Path\n"
        f"h = Path({str(HARNESS)!r})\n"
        "[spec.load_module(p) for d in ('metrics', 'rooflines', 'loops') "
        "for p in sorted((h / d).glob('*.py'))]\n"
        "import gpufluidsimulator_torch.ops.inc, "
        "gpufluidsimulator_torch.ops.render\n")
    assert "gpufluidsimulator_torch" in tops
    assert not tops & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    tops = loaded(f"import sys; sys.path.insert(0, {str(HARNESS)!r})\n"
                  "import fbench.reference, fbench.scene, fbench.check")
    assert "torch" in tops
    assert not tops & (FORBIDDEN | {"gpufluidsimulator_torch"})


def test_calibration_loads_nothing_of_jax():
    tops = loaded(f"import sys; sys.path.insert(0, {str(HARNESS)!r})\n"
                  "import runpy; runpy.run_path('benchmark/calibrate.py', "
                  "run_name='x')\n"
                  "from fbench import bench, program")
    assert not tops & FORBIDDEN
