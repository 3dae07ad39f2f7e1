"""PyTorch port vs JAX package: the density and force sweeps over the rank
planes, on the same JAX-built planes.

The JAX sweeps run as its own tests run them on the CPU (Pallas interpret
mode); the port's wrappers take their plain PyTorch versions for CPU
tensors.  Compared on valid ranks of interior cells — the only slots the
step reads — with relative tolerances (summation order and rsqrt differ):
rho <= 1e-5, acceleration <= 1e-4.  The port defines every other slot as 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

import gpufluidsimulator_tpu as jfs
from gpufluidsimulator_tpu.ops import pallas_sph as jsph
from gpufluidsimulator_tpu.ops import planes as jpm

from gpufluidsimulator_torch import _build, convert
from gpufluidsimulator_torch.ops import planes as tpm
from gpufluidsimulator_torch.ops import sph as tsph


def _scene(case):
    if case == "multi_tile":
        # tests/test_pallas_vs_naive.py's multi-x-tile setup (n_bx > 1)
        params, _ = jfs.scenes.dam_break(n=900, dim=2, jitter=0.2, seed=5)
        params = params.replace(bounds_min=(0.0, 0.0), bounds_max=(4.0, 1.0))
        bx = 126 * params.cell
        state = jfs.scenes.spawn_box(params, [bx - 0.2, 0.0],
                                     [bx + 0.2, 0.25], jitter=0.2, seed=5)
        return params, state
    dim, n = {"2d": (2, 600), "3d": (3, 1200)}[case]
    return jfs.scenes.dam_break(n=n, dim=dim, jitter=0.3, seed=11)


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-9)


@pytest.mark.parametrize("case", ["2d", "3d", "multi_tile"])
def test_sweeps_match_jax(case):
    jp, js = _scene(case)
    geom = jpm.geometry(jp)
    if case == "multi_tile":
        assert geom.n_bx > 1
    table = jpm.build_planes(js.pos, js.vel, js.ids, jp, geom)
    occ_q, occ_s = jpm.occupancy_bounds(table.planes, jp, geom)
    rho_j = jsph.density_planes(table.planes[:jpm.N_POS_FIELDS], occ_q,
                                occ_s, jp, geom)
    rho_h = jpm.halo_x(rho_j)
    acc_j = np.asarray(jsph.accel_planes(table.planes, rho_h, occ_q, occ_s,
                                         jp, geom))
    rho_j = np.asarray(rho_j)

    tp = convert.params_from_dict(dataclasses.asdict(jp))
    tgeom = tpm.geometry(tp)
    pi = convert.planes_from_numpy(table.planes, table.slot, table.ok,
                                   occ_q, occ_s, device="cpu")
    valid = np.asarray(table.planes[jpm.FIELD_X] < jpm.SENTINEL * 0.5)
    mask = valid & tpm.interior_mask(tgeom).numpy()[None]
    assert mask.sum() == js.n

    rho_t = tsph.density_planes(pi.planes[:tpm.N_POS_FIELDS], pi.occ_q,
                                pi.occ_s, tp, tgeom).numpy()
    assert rho_t.shape == rho_j.shape
    assert _rel(rho_t[mask], rho_j[mask]) <= 1e-5
    assert not rho_t[~mask].any()

    acc_t = tsph.accel_planes(pi.planes, torch.from_numpy(np.array(rho_h)),
                              pi.occ_q, pi.occ_s, tp, tgeom).numpy()
    assert acc_t.shape == acc_j.shape
    assert _rel(acc_t[:, mask], acc_j[:, mask]) <= 1e-4
    assert not acc_t[:, ~mask].any()
    if jp.dim == 2:
        assert not acc_t[2].any()


def test_density_plain_counts_self_and_neighbours():
    """Two particles closer than h in one 2D cell pair: each density is
    m * poly6(0) + m * poly6(r^2), independent of rank order."""
    jp, _ = jfs.scenes.dam_break(n=600, dim=2)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    geom = tpm.geometry(tp)
    r = 0.5 * tp.h
    pos = torch.tensor([[0.31, 0.42], [0.31 + r, 0.42]])
    table = tpm.build_planes(pos, torch.zeros_like(pos),
                             torch.arange(2, dtype=torch.int32), tp, geom)
    occ_q, occ_s = tpm.occupancy_bounds(table.planes, tp, geom)
    rho = tsph.density_planes(table.planes[:3], occ_q, occ_s, tp, geom)
    per = rho.reshape(geom.k, -1).flatten()[table.slot.long()]
    d = pos[1, 0] - pos[0, 0]
    m = tp.particle_mass
    from gpufluidsimulator_torch.ops import kernels
    want = m * (kernels.poly6(torch.tensor(0.0), tp.h, 2)
                + kernels.poly6(d * d, tp.h, 2))
    assert torch.allclose(per, want.expand(2), rtol=1e-6)


# -Xptxas -v's report as nvcc 12 prints it for sm_90a: one
# "Compiling entry function" line per kernel, its stack / spill line, and
# its register / shared memory line
_PTXAS = {
    "no_spills": ("== compact.cu\n"
                  "ptxas info    : Compiling entry function "
                  "'_Z14compact_kernel7FkChansiPKfxPfiPiiS3_' for 'sm_90a'\n"
                  "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
                  "loads\n"
                  "ptxas info    : Used 32 registers, used 1 barriers, 44 "
                  "bytes smem\n",
                  {"_Z14compact_kernel7FkChansiPKfxPfiPiiS3_":
                   {"registers": 32, "spills": 0, "static_smem": 44}}),
    "spills": ("ptxas info    : Compiling entry function '_Z1kv' for "
               "'sm_90a'\n"
               "ptxas info    : Function properties for _Z1kv\n"
               "    16 bytes stack frame, 12 bytes spill stores, 8 bytes "
               "spill loads\n"
               "ptxas info    : Used 255 registers, used 1 barriers, 3360 "
               "bytes smem, 1104 bytes cmem[0]\n",
               {"_Z1kv": {"registers": 255, "spills": 20,
                          "static_smem": 3360}}),
    "no_smem": ("ptxas info    : Compiling entry function '_Z1kv' for "
                "'sm_90a'\n"
                "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
                "loads\n"
                "ptxas info    : Used 28 registers\n",
                {"_Z1kv": {"registers": 28, "spills": 0, "static_smem": 0}}),
    "two_sources": ("== a.cu\nptxas info    : 0 bytes gmem\n"
                    "ptxas info    : Compiling entry function '_Z1av' for "
                    "'sm_90a'\n"
                    "0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                    "spill loads\n"
                    "ptxas info    : Used 64 registers, used 1 barriers, "
                    "3360 bytes smem\n"
                    "== b.cu\n"
                    "ptxas info    : Compiling entry function '_Z1bv' for "
                    "'sm_90a'\n"
                    "4 bytes stack frame, 4 bytes spill stores, 4 bytes "
                    "spill loads\n"
                    "ptxas info    : Used 40 registers, used 1 barriers, "
                    "128 bytes smem\n",
                    {"_Z1av": {"registers": 64, "spills": 0,
                               "static_smem": 3360},
                     "_Z1bv": {"registers": 40, "spills": 8,
                               "static_smem": 128}}),
}


@pytest.mark.parametrize("case", sorted(_PTXAS))
def test_ptxas_report_reads_each_entry(case):
    """_build.ptxas_report, the one reader of the build's -Xptxas -v log
    (chip_smoke.py prints it per kernel on its build line): one entry per
    kernel, spill stores and loads summed, a missing smem figure read as
    0."""
    text, want = _PTXAS[case]
    assert _build.ptxas_report(text) == want
