"""The roofline counts: the reference cell list's pairs within h equal a
brute-force count over all pairs, and each kernel's bytes are its
particle fields, read once and written once."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import HARNESS
from fbench import reference, roofline, scene, spec


def brute_pairs(x: torch.Tensor, h: float) -> int:
    d = x[:, None, :] - x[None, :, :]
    r2 = torch.sum(d * d, dim=-1)
    return int(((r2 < h * h) & ~torch.eye(x.shape[0], dtype=torch.bool))
               .sum())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_cell_list_pairs_equal_all_pairs(seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((1500, 3), generator=g, dtype=torch.float64)
    x[:200] = 0.5 + 0.01 * torch.rand((200, 3), generator=g,
                                      dtype=torch.float64)   # a dense clump
    x[200:220, 0] = 1.0                                      # on a wall
    h = 0.07
    assert reference.pair_count(x, h, (0, 0, 0), (1, 1, 1)) \
        == brute_pairs(x, h)


def test_lattice_pairs_equal_all_pairs():
    cfg = json.loads((HARNESS / "configs" / "ddb3d_1m.json").read_text())
    cfg["scene"]["n_request"] = 1500
    c = scene.constants(cfg)
    x = torch.from_numpy(scene.positions(cfg, 9)).double()
    assert reference.pair_count(x, c.h, c.bounds_min, c.bounds_max) \
        == brute_pairs(x, c.h)


@pytest.mark.parametrize("kernel,fields", [
    # bytes per particle: float32 fields read and written, the flag a byte
    ("density", 3 * 4 + 4),
    ("force_step", (3 + 3 + 1) * 4 + (3 + 3) * 4 + 1)])
def test_bytes_are_the_fields(kernel, fields):
    count = spec.roofline_count(HARNESS, kernel)
    nbytes, flops = count(1000, 9000.0, 3)
    assert nbytes == 1000 * fields
    per_pair = {"density": 13, "force_step": 32}
    extra = 1000 if kernel == "density" else 0
    assert flops == per_pair[kernel] * (9000.0 + extra)


def test_bound_is_the_larger_rate():
    assert roofline.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert roofline.bound_s(0.0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)
