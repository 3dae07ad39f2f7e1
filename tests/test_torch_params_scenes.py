"""PyTorch port vs JAX package: parameters, plane geometry, scenes, convert.

Both packages build their inputs from the same calls; integer and layout
results must be identical, positions bitwise equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import gpufluidsimulator_tpu as jfs
from gpufluidsimulator_tpu.models import params as jparams
from gpufluidsimulator_tpu.ops import planes as jpm

import gpufluidsimulator_torch as tfs
from gpufluidsimulator_torch import convert
from gpufluidsimulator_torch.models import params as tparams
from gpufluidsimulator_torch.ops import planes as tpm


def _scene_params():
    out = []
    for name, dim, n in (("dam_break", 2, 600), ("dam_break", 3, 1200),
                         ("dam_break", 3, 262144),
                         ("double_dam_break", 3, 1_000_000),
                         ("spawn_boxes", 2, 900), ("spawn_boxes", 3, 1200)):
        jp, _ = jfs.scenes.SCENES[name](n=min(n, 2000), dim=dim)
        out.append(jp)
    return out


def test_simparams_fields_and_defaults_match():
    jf = dataclasses.fields(jparams.SimParams)
    tf = dataclasses.fields(tparams.SimParams)
    assert [f.name for f in jf] == [f.name for f in tf]
    for a, b in zip(jf, tf):
        assert a.default == b.default, a.name
    assert dataclasses.asdict(jparams.SimParams()) == \
        dataclasses.asdict(tparams.SimParams())


@pytest.mark.parametrize("kw", [
    dict(dim=4),
    dict(dim=2),                                  # 3-long gravity/bounds
    dict(eos="stiff"),
    dict(cell_aniso=(0.04, 0.04)),
    dict(cell_aniso=(0.04, -0.04, 0.04)),
    dict(cell_aniso=(0.04, 0.02, 0.04)),
    dict(cell_aniso=(0.005, 0.04, 0.04)),
    dict(cont_form="other"),
    dict(cont_form="relax", cont_relax=1.0),
    dict(cont_form="sum", cont_delta=0.1),
    dict(cont_delta=0.1, viscosity=0.0),
])
def test_simparams_validation_matches(kw):
    with pytest.raises(ValueError):
        jparams.SimParams(**kw)
    with pytest.raises(ValueError):
        tparams.SimParams(**kw)


def test_properties_geometry_snap_match():
    cases = _scene_params() + [
        jparams.SimParams(cell_aniso=(0.02, 0.04, 0.04)),
        jparams.SimParams(dim=2, gravity=(0.0, -9.81), bounds_min=(0.0, 0.0),
                          bounds_max=(4.0, 1.0), h=0.01),
    ]
    for jp in cases:
        tp = convert.params_from_dict(dataclasses.asdict(jp))
        for prop in ("cell", "cells_axis", "x_halfwidth", "grid_res",
                     "num_cells", "sound_speed"):
            assert getattr(jp, prop) == getattr(tp, prop), prop
        assert tparams.SimParams.replace(tp, dt=1e-5).dt == 1e-5
        if jp.x_halfwidth != 1:
            with pytest.raises(ValueError):
                tpm.geometry(tp)
            continue
        assert tuple(jpm.geometry(jp)) == tuple(tpm.geometry(tp))
        snapped = tpm.snap_cell(tp.replace(cell_size=0.0))
        assert dataclasses.asdict(snapped) == dataclasses.asdict(
            jpm.snap_cell(jp.replace(cell_size=0.0)))
        assert tpm.lattice_dx(tp) == jpm.lattice_dx(jp)


@pytest.mark.parametrize("name,dim,n,jitter", [
    ("dam_break", 2, 600, 0.0), ("dam_break", 3, 1200, 0.3),
    ("double_dam_break", 2, 800, 0.2), ("double_dam_break", 3, 1200, 0.0),
    ("spawn_boxes", 2, 900, 0.1), ("spawn_boxes", 3, 1200, 0.0),
])
def test_scenes_bitwise_equal(name, dim, n, jitter):
    jp, js = jfs.scenes.SCENES[name](n=n, dim=dim, jitter=jitter, seed=4)
    tp, ts = tfs.scenes.SCENES[name](n=n, dim=dim, jitter=jitter, seed=4,
                                     device="cpu")
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    assert np.array_equal(np.asarray(js.pos), ts.pos.numpy())
    assert np.array_equal(np.asarray(js.vel), ts.vel.numpy())
    assert np.array_equal(np.asarray(js.ids), ts.ids.numpy())
    assert ts.ids.dtype == torch.int32 and ts.pos.dtype == torch.float32
    assert int(ts.overflow) == int(js.overflow) == 0


def test_spawn_box_velocity_and_add_states():
    jp, _ = jfs.scenes.dam_break(n=400, dim=2)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    ja = jfs.scenes.spawn_box(jp, [0.1, 0.1], [0.3, 0.3], velocity=(1.0, -2.0))
    ta = tfs.scenes.spawn_box(tp, [0.1, 0.1], [0.3, 0.3], velocity=(1.0, -2.0),
                              device="cpu")
    jb = jfs.scenes.spawn_box(jp, [0.5, 0.5], [0.6, 0.7], jitter=0.2, seed=3)
    tb = tfs.scenes.spawn_box(tp, [0.5, 0.5], [0.6, 0.7], jitter=0.2, seed=3,
                              device="cpu")
    jc = jfs.scenes.add_states(ja, jb)
    tc = tfs.scenes.add_states(ta, tb)
    for field in ("pos", "vel", "rho", "pres", "ids"):
        assert np.array_equal(np.asarray(getattr(jc, field)),
                              getattr(tc, field).numpy()), field


def test_convert_round_trips():
    jp, js = jfs.scenes.double_dam_break(n=600, dim=3)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert tp.obstacles == jp.obstacles
    assert convert.params_from_dict(dataclasses.asdict(tp)) == tp
    ts = convert.state_from_numpy(*(np.asarray(a) for a in js),
                                  device="cpu")
    for a, b in zip(js, ts):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert ts.overflow.shape == () and ts.ids.dtype == torch.int32

    geom = jpm.geometry(jp)
    table = jpm.build_planes(js.pos, js.vel, js.ids, jp, geom)
    occ_q, occ_s = jpm.occupancy_bounds(table.planes, jp, geom)
    pi = convert.planes_from_numpy(np.asarray(table.planes),
                                   np.asarray(table.slot),
                                   np.asarray(table.ok), np.asarray(occ_q),
                                   np.asarray(occ_s), device="cpu")
    assert np.array_equal(pi.planes.numpy(), np.asarray(table.planes))
    assert np.array_equal(pi.slot.numpy(), np.asarray(table.slot))
    assert np.array_equal(pi.ok.numpy(), np.asarray(table.ok))
    assert pi.occ_q.dtype == torch.int32 and pi.ok.dtype == torch.bool
    assert np.array_equal(pi.occ_s.numpy(), np.asarray(occ_s))
