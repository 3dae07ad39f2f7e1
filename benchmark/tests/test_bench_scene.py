"""The harness makes the program's documented scenes itself: the same
particles and the same parameters as ``gpufluidsimulator_torch.scenes``
builds from the same request, jitter and seed."""

from __future__ import annotations

import json

import numpy as np
import pytest

from conftest import HARNESS
from fbench import program, scene
from gpufluidsimulator_torch.models import scenes


# the single dam break (BASELINE.json configs[2]) on the cell's physics: a
# second scene of the harness's generator, which no cell runs yet
DAM_BREAK = {"dim": 3, "fluid_volume": [0.4, 0.8, 1.0], "height": 0.8,
             "fluid_boxes": [[[0.0, 0.0, 0.0], [0.4, 0.8, 1.0]]],
             "bounds": [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], "obstacles": []}


def config(scene_=None, n=None):
    cfg = json.loads((HARNESS / "configs" / "ddb3d_1m.json").read_text())
    if scene_ is not None:
        cfg["scene"] = dict(scene_)
    cfg["scene"]["n_request"] = n
    return cfg


@pytest.mark.parametrize("scene_,fn,n", [
    (DAM_BREAK, scenes.dam_break, 3000),
    (None, scenes.double_dam_break, 4000)])
def test_scene_matches_program(scene_, fn, n):
    cfg = config(scene_, n)
    seed = 123
    jitter = cfg["assumed"]["jitter"]
    p_ref, s_ref = fn(n=n, dim=3, jitter=jitter, seed=seed, device="cpu")
    pos = scene.positions(cfg, seed)
    np.testing.assert_array_equal(pos, s_ref.pos.numpy())
    assert program.params(scene.constants(cfg)) == p_ref


def test_seed_changes_inputs_not_sizes():
    cfg = config(DAM_BREAK, 2000)
    a = scene.positions(cfg, 2 ** 31 + 5)
    b = scene.positions(cfg, 2 ** 31 + 6)
    assert a.shape == b.shape and not np.array_equal(a, b)
    np.testing.assert_array_equal(a, scene.positions(cfg, 2 ** 31 + 5))
