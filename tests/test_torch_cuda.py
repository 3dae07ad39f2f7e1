"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card.  Marked ``cuda``; every test skips without a CUDA device.

Imports nothing of JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py -q

Small scenes that reach the branches the 260,850-particle check in
``chip_smoke.py`` does not: 2D, several x tiles (halo lanes), the Tait EOS
and a cell capacity of 16 (the kernels' second register width).
Tolerances as in ``chip_smoke.py``: occupancy, placement and gather exact;
density relative 1e-5 and force 1e-4 (summation order and ``rsqrtf``).
"""

import numpy as np
import pytest
import torch

import gpufluidsimulator_torch as ft
from gpufluidsimulator_torch import _build
from gpufluidsimulator_torch.ops import planes as pm
from gpufluidsimulator_torch.ops import route, sph

pytestmark = pytest.mark.cuda

CASES = ["2d", "3d", "multi_tile", "3d_tait", "3d_k16"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(case):
    if case == "multi_tile":
        params, _ = ft.scenes.dam_break(n=900, dim=2, jitter=0.2, seed=5,
                                        device="cpu")
        params = params.replace(bounds_min=(0.0, 0.0), bounds_max=(4.0, 1.0))
        bx = 126 * params.cell
        state = ft.scenes.spawn_box(params, [bx - 0.2, 0.0],
                                    [bx + 0.2, 0.25], jitter=0.2, seed=5,
                                    device="cpu")
        assert pm.geometry(params).n_bx > 1
        return params, state
    dim, n = (2, 600) if case == "2d" else (3, 1200)
    params, state = ft.scenes.dam_break(n=n, dim=dim, jitter=0.3, seed=11,
                                        device="cpu")
    if case == "3d_tait":
        params = params.replace(eos="tait")
    if case == "3d_k16":
        params = params.replace(cell_capacity=16)
    return params, state


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-9))


@pytest.mark.parametrize("case", CASES)
def test_kernels_match_plain(cuda, case):
    params, state = _scene(case)
    geom = pm.geometry(params)
    table = pm.build_planes(*(t.to(cuda) for t in
                              (state.pos, state.vel, state.ids)),
                            params, geom)
    planes = table.planes
    before = dict(_build.launches)

    got = pm.occ_rowmax(planes[pm.FIELD_X], geom)
    assert torch.equal(got, pm.occ_rowmax_plain(planes[pm.FIELD_X]))

    fields = torch.cat([table.pos_s.T, table.vel_s.T]).contiguous()
    got = route.place(fields, table.slot, table.ok, geom, params.dim)
    want = route.place_plain(fields, table.slot, table.ok, geom, params.dim)
    assert torch.equal(got, want)

    occ_q, occ_s = pm.occupancy_bounds(planes, params, geom)
    pos_planes = planes[:pm.N_POS_FIELDS]
    rho = sph.density_planes(pos_planes, occ_q, occ_s, params, geom)
    rho_plain = sph.density_plain(pos_planes, params, geom)
    assert _rel(rho, rho_plain) <= 1e-5
    rho = pm.halo_x(rho)

    acc = sph.accel_planes(planes, rho, occ_q, occ_s, params, geom)
    assert _rel(acc, sph.accel_plain(planes, rho, params, geom)) <= 1e-4

    stack = torch.cat([acc, rho[None]]).contiguous()
    got = route.gather(stack, table.slot)
    assert torch.equal(got, route.gather_plain(stack, table.slot))
    torch.cuda.synchronize()
    # occ_rowmax twice: directly and through occupancy_bounds
    want_counts = {"occ_rowmax": 2, "place": 1, "density": 1, "force": 1,
                   "gather": 1}
    assert {k: _build.launches[k] - before[k] for k in before} == want_counts


@pytest.mark.parametrize("case", CASES)
def test_step_on_card_matches_cpu(cuda, case):
    params, state = _scene(case)
    gpu = ft.FluidSim(params, state, method="pallas", device=cuda)
    cpu = ft.FluidSim(params, state, method="pallas", device="cpu")
    gpu.step(1)
    cpu.step(1)
    assert int(gpu.state.overflow) == int(cpu.state.overflow)
    og = np.argsort(gpu.state.ids.cpu().numpy())
    oc = np.argsort(cpu.state.ids.numpy())
    for key, tol in (("rho", 1e-5), ("pos", 1e-6), ("vel", 1e-4)):
        a = getattr(gpu.state, key).cpu()[og]
        b = getattr(cpu.state, key)[oc]
        assert _rel(a, b) <= tol, key


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    params, state = _scene("2d")
    geom = pm.geometry(params)
    x = torch.full((geom.k, geom.pz, geom.n_bx, geom.py, pm.LANES),
                   pm.SENTINEL, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        pm.occ_rowmax(x, geom)
    with pytest.raises(ValueError, match="contiguous"):
        pm.occ_rowmax(x.float().transpose(-1, -2).contiguous()
                      .transpose(-1, -2), geom)
