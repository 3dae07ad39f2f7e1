"""Physical invariants of the port's runs on the CPU, at the reference's
sizes and step counts (``tests/test_invariants.py:13-77``).

The checks live in ``scripts/torch_invariants.py``, which ``chip_smoke.py``
runs on the card too; here they run with ``device="cpu"``, on ``naive``
(all six) and on the incremental plane path ``pallas_inc`` (momentum,
finiteness, bounds, obstacles).  The bars are the reference's:

  * momentum drift of a free blob under zero gravity (30 steps): below
    1e-4 of n x the largest |v|;
  * kinetic energy of the 2D dam break of 400 (300 steps): below 2x the
    column's initial potential energy;
  * every field finite (400 steps);
  * two runs bitwise equal (50 steps);
  * positions within 1e-6 of the box (300 steps);
  * the 2D double dam break's obstacles: no particle deeper than 1e-4
    inside (200 steps; on ``naive`` over a minute on one torch thread, so
    under ``slow``).

The soak's record (``scripts/torch_soak.py``) is checked at a small size.
"""

import pytest
import torch

from scripts import torch_invariants as inv
from scripts import torch_soak


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the plain versions run many small
    ops, and several test processes share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _holds(result):
    assert result["ok"], result


@pytest.mark.parametrize("method", ["naive", "pallas_inc"])
def test_momentum_conserved_zero_gravity(method):
    r = inv.momentum(method, "cpu")
    assert r["off_walls"], "test invalid: blob reached the walls"
    _holds(r)


def test_energy_bounded_dam_break():
    _holds(inv.energy("naive", "cpu"))


@pytest.mark.parametrize("method", ["naive", "pallas_inc"])
def test_no_nan_long_scan(method):
    _holds(inv.finite(method, "cpu"))


def test_determinism_bitwise():
    _holds(inv.determinism("naive", "cpu"))


@pytest.mark.parametrize("method", ["naive", "pallas_inc"])
def test_particles_stay_in_bounds(method):
    _holds(inv.bounds(method, "cpu"))


@pytest.mark.parametrize("method", [
    pytest.param("naive", marks=pytest.mark.slow), "pallas_inc"])
def test_obstacles_exclude_particles(method):
    _holds(inv.obstacles(method, "cpu"))


def test_soak_record():
    """Both tiers of the soak at a small size: every chunk recorded, every
    particle live, no overflow, finite."""
    for continuity in (False, True):
        out = torch_soak.soak(n=1000, steps=6, chunk=2,
                              continuity=continuity, device="cpu")
        assert [r["step"] for r in out["rows"]] == [4, 6]
        assert torch_soak.failures(out) == []
        assert out["summary"]["live_final"] == out["config"]["n"]
        assert out["config"]["method"] == ("pallas_inc_cont" if continuity
                                           else "pallas_inc")
