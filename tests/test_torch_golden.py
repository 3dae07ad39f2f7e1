"""The committed golden frames, and the port's naive runs behind them.

For each recipe of ``tests/golden/regen.py`` (a 2D dam break, a 3D
camera-projected dam break and the obstacle scene, run on ``naive``):

  * the port's ``render_frame`` + ``tonemap`` of the reference's final
    naive state hashes to the committed ``.sha256``: the renderer is
    exact against the golden frames;
  * the port's own naive run (``device="cpu"``) ends within 1e-4 of the
    reference's final positions (relative to the largest, particles by
    id): the naive trajectory bound.  Frames of the port's own runs are
    not hashed: float32 sums in another order leave the 2D and 3D scenes'
    positions about 3e-6 from the reference's, which moves a few hundred
    of a frame's bytes.

The port's 2D dam break (400 steps of 1,485 particles) and obstacle scene
(200 steps of 1,500) take over a minute on one torch thread, so they run
under ``slow``.
"""

import dataclasses
import functools
import hashlib
import os
import sys

import numpy as np
import pytest
import torch

import gpufluidsimulator_tpu as jfs

import gpufluidsimulator_torch as tfs
from gpufluidsimulator_torch import convert
from gpufluidsimulator_torch.ops import render as trender

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
NAMES = ("dam_break_2d_400", "dam_break_3d_120",
         "double_dam_obstacles_2d_200")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the plain versions run many small
    ops, and several test processes share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _goldens() -> dict:
    sys.path.insert(0, GOLDEN_DIR)
    try:
        from regen import GOLDENS
    finally:
        sys.path.remove(GOLDEN_DIR)
    return GOLDENS


@functools.cache
def _reference_run(name):
    """(reference params, reference initial state, its final naive
    state), as tests/test_render.py runs the recipe."""
    fn, kw, steps, _ = _goldens()[name]
    params, state = fn(**kw)
    return params, state, jfs.run(state, params, steps, method="naive")


def _port(jp, js):
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    ts = convert.state_from_numpy(*(np.asarray(a) for a in js),
                                  device="cpu")
    return tp, ts


@pytest.mark.parametrize("name", NAMES)
def test_port_renders_reference_state_to_golden_hash(name):
    want = open(os.path.join(GOLDEN_DIR, f"{name}.sha256")).read().strip()
    rkw = _goldens()[name][3]
    jp, _, jfinal = _reference_run(name)
    tp, tfinal = _port(jp, jfinal)
    img = trender.tonemap(trender.render_frame(tfinal, tp, width=256,
                                               height=256, **rkw))
    got = hashlib.sha256(img.tobytes()).hexdigest()
    assert got == want, f"frame diverged from tests/golden/{name}.png"


@pytest.mark.parametrize("name", [
    pytest.param("dam_break_2d_400", marks=pytest.mark.slow),
    "dam_break_3d_120",
    pytest.param("double_dam_obstacles_2d_200", marks=pytest.mark.slow)])
def test_port_naive_run_tracks_reference(name):
    steps = _goldens()[name][2]
    jp, jstate, jfinal = _reference_run(name)
    tp, tstate = _port(jp, jstate)
    st = tfs.run(tstate, tp, steps, method="naive", device="cpu")
    got = st.pos.numpy()[np.argsort(st.ids.numpy())]
    want = np.asarray(jfinal.pos)[np.argsort(np.asarray(jfinal.ids))]
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-9)
    assert err < 1e-4
    assert int(st.overflow) == 0
