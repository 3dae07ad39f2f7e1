"""PyTorch port vs JAX package: the per-particle gather out of the rank
planes (``route.gather``, kernel 5), on identical inputs on the CPU.

The port's one gather stands for the reference's extract + stitch kernels
(``route._extract_kernel``, ``route._stitch_kernel``), whose contract is
``out[i, c] = stack[c].flat[min(slot[i], K*cells - 1)]``.  The slots come
from the port's binning of a small scene (2D, and 3D at a cell capacity of
2 with a crowded cell, so that particles are dropped and their slot
clamps).  The reference's placement (``route.place``) works out its own
routing shifts for those slots, with no field to route (the position and
velocity fields that ``planes.build_planes`` routes too would add seconds
of compile on the CPU), at the tile starts that ``planes.build_planes``
works out (a ``searchsorted`` of the tile bases).  The values are
numpy-seeded.

Each scene runs the reference's kernels in interpret mode, jitted, on
four channels one at a time: the extract and stitch kernels route each
channel on its own, so one compiled program serves every channel, and
the three-channel case is held against the first three.  Held exactly: the ``ok`` rows against the interpret-mode
kernels (as ``tests/test_route.py`` compares them), every row, dropped
ones too, against the reference's CPU contract (``use_kernel=False``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufluidsimulator_tpu.ops import planes as jpm
from gpufluidsimulator_tpu.ops import route as jroute

import gpufluidsimulator_torch as ft
from gpufluidsimulator_torch.ops import planes as tpm
from gpufluidsimulator_torch.ops import route as troute

SCENES = ["2d", "3d_dropped"]


@functools.partial(jax.jit, static_argnames=("geom",))
def _reference(vals, slot, geom):
    """The reference's extract + stitch kernels (interpret mode) and its CPU
    contract on the channels ``vals`` at slot-sorted ``slot``, through the
    routing shifts and tile starts of its own placement."""
    n = slot.shape[0]
    rows = jroute.pad_rows(n)
    slot2d = jnp.pad(slot, (0, rows * jpm.LANES - n),
                     constant_values=geom.k * geom.cells + jroute.LOCAL)
    bases = jnp.arange(jroute.n_tiles(geom) + 1, dtype=jnp.int32) \
        * jroute.TILE
    starts = jnp.searchsorted(slot, bases).astype(jnp.int32)
    shifts = jroute.place([], slot2d.reshape(rows, jpm.LANES), starts, geom,
                          n_pos=0, use_kernel=False)[0]
    return tuple(jroute.extract_per_particle(vals, shifts, slot, starts, geom,
                                             use_kernel=kern)
                 for kern in (True, False))


@functools.cache
def _case(scene):
    """(slot, ok, values, interpret-mode reference, CPU-contract reference)
    of one scene; the values and references have four channels."""
    dim, n = (3, 60) if scene == "3d_dropped" else (2, 300)
    params, state = ft.scenes.dam_break(n=n, dim=dim, jitter=0.3, seed=11,
                                        device="cpu")
    pos = state.pos.numpy().copy()
    if scene == "3d_dropped":
        # 20 particles into the first particle's cell, past K = 2; the
        # small K also cuts the routing tiles the kernels interpret to 14
        params = params.replace(cell_capacity=2)
        rng = np.random.default_rng(1)
        pos[:20] = pos[0] + rng.uniform(0.0, 0.1 * params.cell, (20, dim))
    state = ft.make_state(pos, state.vel.numpy(), device="cpu")
    geom = tpm.geometry(params)
    table = tpm.build_planes(state.pos, state.vel, state.ids, params, geom)
    slot = table.slot.numpy()
    ok = table.ok.numpy()
    assert (not ok.all()) == (scene == "3d_dropped")
    assert (slot[~ok] >= geom.k * geom.cells).all()
    jgeom = jpm.PlaneGeom(*geom)
    rng = np.random.default_rng(7)
    vals = rng.normal(size=(4, geom.k, geom.pz, geom.n_bx, geom.py,
                            jpm.LANES)).astype(np.float32)
    kern, cont = (np.concatenate(r, axis=1) for r in zip(*(
        _reference(jnp.asarray(vals[c:c + 1]), jnp.asarray(slot), jgeom)
        for c in range(vals.shape[0]))))
    return slot, ok, vals, kern, cont


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("scene", SCENES)
def test_gather_matches_reference(scene, channels):
    torch.set_num_threads(1)
    slot, ok, vals, kern, cont = _case(scene)
    got = troute.gather(torch.from_numpy(vals[:channels]).contiguous(),
                        torch.from_numpy(slot))
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert tuple(got.shape) == (slot.shape[0], channels)
    got = got.numpy()
    np.testing.assert_array_equal(got[ok], kern[ok, :channels])
    np.testing.assert_array_equal(got, cont[:, :channels])
    if not ok.all():
        # dropped particles read the last slot of each channel
        last = vals[:channels].reshape(channels, -1)[:, -1]
        np.testing.assert_array_equal(got[~ok], np.broadcast_to(
            last, (int((~ok).sum()), channels)))
