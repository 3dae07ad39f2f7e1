"""PyTorch port vs JAX package: the packed-pair force sweep
(``ops/mxu_sweep.py``) on the CPU with identical inputs.

Packing and the descriptor are exact: the packed rows, sorted cell ids,
sort order and candidate ranges equal the reference's, and so do the slot
table and its padding accounting.  The port's acceleration (its plain
version here) is held within 2e-5 relative to the largest magnitude of the
reference's, in both of its reduction variants ("vpu" and "mxu", Pallas
interpret mode as ``tests/test_mxu_sweep.py`` runs them), and of the port's
all-pairs acceleration less gravity: the bound that
``tests/test_mxu_sweep.py`` holds the reference to.
"""

import dataclasses

import numpy as np
import pytest
import torch

import gpufluidsimulator_tpu as jfs
from gpufluidsimulator_tpu.models import solver as jsolver
from gpufluidsimulator_tpu.ops import mxu_sweep as jmxu
from gpufluidsimulator_tpu.ops import naive as jnaive
from gpufluidsimulator_tpu.ops import physics as jphysics

from gpufluidsimulator_torch import convert
from gpufluidsimulator_torch.ops import mxu_sweep as tmxu
from gpufluidsimulator_torch.ops import naive as tnaive


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share the host: one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _settled(n, steps=5, seed=3):
    """tests/test_mxu_sweep.py's input: a 3D dam break settled by a few
    all-pairs steps, with its summation density and pressure.  Returns the
    reference's params and arrays, and the port's."""
    jp, js = jfs.scenes.dam_break(n=n, dim=3, jitter=0.3, seed=seed)
    js = jsolver.run(js, jp, steps, method="naive")
    rho = jnaive.density_naive(js.pos, jp)
    pres = jphysics.eos_pressure(rho, jp)
    arrs = [np.array(a) for a in (js.pos, js.vel, rho, pres)]
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    return jp, arrs, tp, [torch.from_numpy(a) for a in arrs]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-9)


@pytest.mark.parametrize("request_n", [1100, 777])
def test_pack_and_desc_exact(request_n):
    jp, arrs, tp, targs = _settled(request_n, steps=3)
    n = arrs[0].shape[0]
    assert n % tmxu.TQ
    f_j, _, cids_j, order_j = jmxu.pack(*arrs, jp)
    f_t, cids_t, order_t = tmxu.pack(*targs, tp)
    assert np.array_equal(f_t.numpy(), np.asarray(f_j))
    assert np.array_equal(cids_t.numpy(), np.asarray(cids_j))
    assert np.array_equal(order_t.numpy(), np.asarray(order_j))
    npad = f_t.shape[0]
    assert npad % tmxu.TQ == 0 and npad - n < tmxu.TQ
    desc_j, max_slots = jmxu.build_desc(np.asarray(cids_j), npad, jp)
    desc_t = tmxu.build_desc(cids_t, npad, tp)
    assert desc_t.dtype == torch.int32
    assert np.array_equal(desc_t.numpy(), desc_j)
    assert int(desc_t[:, 6].max()) == max_slots
    # the sentinel tail: pad rows far away with zero fields, and no range
    # reaches them
    assert (f_t[n:, :3] == tmxu.SENTINEL).all() and (f_t[n:, 3:] == 0).all()
    assert int(desc_t[:, :6].max()) <= n


def test_slot_table_and_stats_equal():
    jp, arrs, tp, targs = _settled(900, steps=2)
    _, _, cids_j, _ = jmxu.pack(*arrs, jp)
    cids = np.asarray(cids_j)
    npad = -(-len(cids) // jmxu.TQ) * jmxu.TQ
    desc, _ = jmxu.build_desc(cids, npad, jp)
    for a, b in zip(tmxu.slot_table(desc), jmxu.slot_table(desc)):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    assert tmxu.table_stats(cids, npad, tp) == jmxu.table_stats(cids, npad,
                                                                jp)


@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_accel_mxu_matches_jax(variant):
    jp, arrs, tp, targs = _settled(1100)
    want = np.asarray(jmxu.accel_mxu(*arrs, jp, variant=variant))
    got = tmxu.accel_mxu(*targs, tp).numpy()
    assert _rel(got, want) < 2e-5
    naive = tnaive.accel_naive(*targs, tp) - torch.tensor(tp.gravity)
    assert _rel(got, naive.numpy()) < 2e-5


def test_tail_and_chunked_plain(monkeypatch):
    """715 particles, not a multiple of 128: the last tile's pad queries
    get 0 and its real queries match the all-pairs acceleration; chunks of
    7 slots give the result of one chunk."""
    jp, arrs, tp, targs = _settled(777, steps=3)
    n = arrs[0].shape[0]
    f, cids, _ = tmxu.pack(*targs, tp)
    desc = tmxu.build_desc(cids, f.shape[0], tp)
    whole = tmxu.sweep_packed(f, desc, tp)
    assert whole.shape == (f.shape[0], 3) and f.shape[0] > n
    assert (whole[n:] == 0).all() and (whole[:n] != 0).any(dim=1).all()
    monkeypatch.setattr(tmxu, "PLAIN_TEMP_BYTES",
                        7 * tmxu._PLAIN_TEMPS * tmxu.TC * tmxu.TQ * 4)
    chunked = tmxu.sweep_packed(f, desc, tp)
    assert _rel(chunked.numpy(), whole.numpy()) <= 1e-6
    got = tmxu.accel_mxu(*targs, tp)
    naive = tnaive.accel_naive(*targs, tp) - torch.tensor(tp.gravity)
    assert _rel(got.numpy(), naive.numpy()) < 2e-5


def test_refuses_stencils_the_descriptor_cannot_cover():
    """build_desc's three ranges assume halfwidth 1 in 3D: 2D and a 3D
    cell_aniso grid with x cells of 0.5 h (x halfwidth 2) raise."""
    _, arrs, tp, targs = _settled(300, steps=1)
    f, cids, _ = tmxu.pack(*targs, tp)
    p2, _ = jfs.scenes.dam_break(n=300, dim=2)
    tp2 = convert.params_from_dict(dataclasses.asdict(p2))
    with pytest.raises(ValueError, match="3D"):
        tmxu.build_desc(cids, f.shape[0], tp2)
    aniso = tp.replace(cell_aniso=(0.5 * tp.h, tp.h, tp.h))
    with pytest.raises(ValueError, match="halfwidth"):
        tmxu.build_desc(cids, f.shape[0], aniso)
    with pytest.raises(ValueError, match="halfwidth"):
        tmxu.accel_mxu(*targs, aniso)
