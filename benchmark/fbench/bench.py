"""One run of one cell: set-up, the measured (or traced) window, the check.

The traffic mix's ``kind`` names its loop, ``loops/<kind>.py`` under the
harness's folder, found by name like a metric's reader.  A loop module
gives:

  warm(c)                   the window's call (or frame) once, at set-up
  window(c, rec, seconds)   the measured window: sets ``rec.window_s``,
                            ``attempted``, ``failed``, ``last`` and what
                            its metrics read
  traced(c, rec, tables)    the traced windows: sets ``rec.trace`` (with
                            at least ``a``, ``b``, ``steps_a``,
                            ``steps_b``), ``window_s``, ``attempted``,
                            ``failed``, ``last``, ``peak_bytes``
  one(c, rec)               one call or one episode, for calibration
  comparisons(c, rec, dtype)
                            each comparison of the timed path with the
                            reference, as ``Comparison``s
  extra_readings(c, cmp, seed)   (optional) calibration's readings of a
                            comparison beyond the states'

Set-up makes the scene from the seed and evolves it by ``warm.pallas``
steps of ``pallas`` and then ``warm.method`` to step ``warm.to_step``
(the port's own benchmark protocol), then warms the loop's call.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple, Optional

import torch

from . import check, scene, spec
from .reference import Reference, pair_count


class Comparison(NamedTuple):
    start: object          # the state the program and the reference start from
    prog: object           # the program's state
    ref: object            # the reference's state
    extra: Optional[tuple]  # a loop's own outputs (a frame's), or None
    numbers: dict


class Cell:
    """A cell made ready to run: the program's parameters, the evolved
    state, and the loop."""

    def __init__(self, cell: spec.Cell, seed: int, device):
        from . import program
        self.prog = program
        self.cell = cell
        self.seed = seed
        self.dev = torch.device(device)
        self.t = cell.traffic
        self.loop = spec.loop_module(cell.harness, self.t["kind"])
        self.const = scene.constants(cell.config)
        self.params = program.params(self.const)
        self.guard = check.Guard(self.const, self.dev)
        self.n = 0
        self.evolved = None

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.dev) \
            if self.dev.type == "cuda" else 0

    def setup(self):
        run = self.prog.solver.run
        warm = self.t["warm"]
        s = self.prog.state(scene.positions(self.cell.config, self.seed),
                            self.dev)
        self.n = s.n
        self.initial = s
        s = run(s, self.params, warm["pallas"], method="pallas",
                device=self.dev)
        s = run(s, self.params, warm["to_step"] - warm["pallas"],
                method=warm["method"], device=self.dev)
        self.evolved = s
        self.loop.warm(self)
        self.sync()

    # -- the check ------------------------------------------------------------
    def reference(self, start, dtype=torch.float64, tier=None):
        """The reference's ``check_steps`` from ``start`` on ``tier`` (the
        window's, or the warm-up's ``pallas``) -> a state with ``start``'s
        ids and the density that tier's entry returns: the density at the
        final positions on the incremental tiers, the one the last step's
        pressure read on ``pallas``."""
        tier = tier or self.t["method"]
        ref = Reference(self.const, dtype,
                        self.cell.config["guarantees"]["resum_every"])
        x, v, rho_final, rho_last = ref.run(
            start.pos, start.vel, self.t["check_steps"],
            continuity=tier == "pallas_inc_cont")
        final = tier != "pallas" and self.t["returned_rho"] == "final"
        return SimpleNamespace(ids=start.ids, pos=x, vel=v,
                               rho=rho_final if final else rho_last)

    def gaps(self, out, ref):
        """The state numbers of ``out`` against ``ref`` (check.py)."""
        return check.state_gaps(out.ids, out.pos, out.vel, out.rho,
                                ref.ids, ref.pos, ref.vel, ref.rho,
                                self.const.h, self.const.stiffness ** 0.5,
                                self.const.rest_density)

    def compare_states(self, start, prog, dtype=torch.float64, tier=None):
        ref = self.reference(start, dtype, tier)
        return Comparison(start, prog, ref, None, self.gaps(prog, ref))


def measure(c: Cell, seconds: float, traced: bool, tables=None):
    """The window -> the record the metric readers and the check read."""
    rec = SimpleNamespace(n=c.n, trace=None, harness=c.cell.harness,
                          dim=c.const.dim)
    if c.dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(c.dev)
    if traced:
        c.loop.traced(c, rec, tables)
        # the pairs within h at the start and the end of window A's call
        # or episode (every one starts from the evolved state)
        rec.trace.pairs = sum(
            pair_count(s.pos, c.const.h, c.const.bounds_min,
                       c.const.bounds_max) for s in (c.evolved, rec.last)) / 2
    else:
        c.loop.window(c, rec, seconds)
        rec.peak_bytes = c.peak()
    rec.failed = int(rec.failed)
    return rec


def comparisons(c: Cell, rec, dtype=torch.float64):
    """Each comparison of the check: the warm-up's first method
    (``pallas``) for ``check_steps`` from the scene the harness made (the
    start of the stage every call skips), then the loop's own."""
    prog = c.prog.solver.run(c.initial, c.params, c.t["check_steps"],
                             method="pallas", device=c.dev)
    yield c.compare_states(c.initial, prog, dtype, "pallas")
    yield from c.loop.comparisons(c, rec, dtype)


def compare(c: Cell, rec, dtype=torch.float64):
    """The reference against the program -> [numbers per comparison]."""
    return [cmp.numbers for cmp in comparisons(c, rec, dtype)]
