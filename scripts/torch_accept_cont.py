"""The full-CFL statistical acceptance of the incremental tiers, on the card.

    python3 scripts/torch_accept_cont.py [alpha] [resum_every]

Counterpart of ``scripts/accept_cont.py`` and of the reference's test
``test_full_cfl_1000_steps_statistical_acceptance``
(``tests/test_naive_vs_oracle.py:44-117``).
At full CFL no float32 path can follow the float64 oracle particle by
particle (one f32 ulp of initial position grows past 1e-3 by step 550,
``docs/chaos_bound.json``), but the flow's distribution can be held to it.
The protocol:

  * the scene is ``scenes.dam_break(n=4096, dim=2)`` at its full CFL dt;
  * the float64 C++ oracle (``oracle/native.run``, cell lists) runs twice:
    from the initial positions, and from a twin moved by one float32 ulp;
  * at the checkpoints (cumulative steps 250, 500, 750, 1000) three
    observables are taken: the 20x20 binned density (total variation),
    the centre of mass (largest axis gap) and the kinetic energy
    (relative gap);
  * the twin's gap to the oracle is the envelope any f32 path lives in;
    a method passes a checkpoint when each gap is within
    ``max(8 x envelope, FLOORS)``;
  * after the last checkpoint the column's centre of mass must have fallen
    by more than ``COM_FALL``.

The method's run is one ``run`` call per checkpoint, as in the reference.
Prints each checkpoint's ``[tv com ke]`` against its tolerance for
``pallas_inc`` and ``pallas_inc_cont``, and the signed kinetic-energy gap
(positive: the method carries more energy than the oracle).  ``alpha``
sets ``cont_alpha``; ``resum_every`` sets ``inc.RESUM_EVERY``.  Exits 1 if
a check fails.  Imports the package next to the scripts folder, never JAX.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

CHECKPOINTS = (250, 250, 250, 250)       # cumulative 1000
FLOORS = np.asarray([0.02, 2e-3, 0.05])  # tv, com, ke: for zero envelopes
ENVELOPE_FACTOR = 8.0
COM_FALL = 0.02
METHODS = ("pallas_inc", "pallas_inc_cont")
BINS = 20


def scene(n: int = 4096, alpha=None, device="cuda"):
    """Config 1's scene at full CFL (``cont_alpha`` = ``alpha`` if given)."""
    from gpufluidsimulator_torch import scenes
    params, state = scenes.dam_break(n=n, dim=2, device=device)
    if alpha is not None:
        params = params.replace(cont_alpha=alpha)
    return params, state


def observables(pos, vel, params):
    """(binned density / n, centre of mass, kinetic energy) of float64
    host arrays."""
    lo, hi = params.bounds_min, params.bounds_max
    hist, _, _ = np.histogram2d(pos[:, 0], pos[:, 1], bins=BINS,
                                range=[[lo[0], hi[0]], [lo[1], hi[1]]])
    return (hist / pos.shape[0], pos.mean(axis=0),
            0.5 * params.particle_mass * float((vel ** 2).sum()))


def gaps(obs, ref) -> np.ndarray:
    """[tv, com, ke] of ``obs`` against ``ref``; ke signed (relative)."""
    tv = 0.5 * np.abs(obs[0] - ref[0]).sum()
    com = np.abs(obs[1] - ref[1]).max()
    ke = (obs[2] - ref[2]) / max(abs(ref[2]), 1e-12)
    return np.asarray([tv, com, ke])


def ulp_twin(pos0: np.ndarray, params) -> np.ndarray:
    """The initial positions moved by one float32 ulp, back in float64:
    the smallest initial difference any f32 implementation could avoid."""
    hi = np.asarray(params.bounds_max)
    return np.asarray(np.nextafter(np.float32(pos0),
                                   np.float32(2.0) * hi.max()), np.float64)


def oracle_checkpoints(params, pos0: np.ndarray, checkpoints=CHECKPOINTS):
    """The oracle's observables and its 1-ulp envelope at each checkpoint:
    (list of observables, list of |gaps| of the twin, seconds)."""
    from gpufluidsimulator_torch.oracle import native
    if not native.available():
        raise RuntimeError(f"native fluidcore unavailable: "
                           f"{native.unavailable_reason()}")
    t0 = time.perf_counter()
    pa, va = pos0.copy(), np.zeros_like(pos0)
    pb, vb = ulp_twin(pos0, params), np.zeros_like(pos0)
    refs, envelopes = [], []
    for k in checkpoints:
        pa, va, _, _ = native.run(pa, va, params, k)
        pb, vb, _, _ = native.run(pb, vb, params, k)
        ref = observables(pa, va, params)
        refs.append(ref)
        envelopes.append(np.abs(gaps(observables(pb, vb, params), ref)))
    return refs, envelopes, time.perf_counter() - t0


def host(t) -> np.ndarray:
    """A tensor as a float64 host array."""
    return t.detach().cpu().double().numpy()


def run_method(params, state0, method, refs, envelopes,
               checkpoints=CHECKPOINTS, device="cuda") -> dict:
    """One method through the checkpoints, one ``run`` call each: a row per
    checkpoint (gaps, tolerance, pass, overflow) and the fall of the
    centre of mass from the start to the end."""
    from gpufluidsimulator_torch import run
    rows = []
    st, step_no = state0, 0
    t0 = time.perf_counter()
    for k, ref, env in zip(checkpoints, refs, envelopes):
        st = run(st, params, k, method=method, device=device)
        step_no += k
        got = gaps(observables(host(st.pos), host(st.vel), params), ref)
        tol = np.maximum(ENVELOPE_FACTOR * env, FLOORS)
        absgot = np.abs(got)
        overflow = int(st.overflow)
        rows.append(dict(step=step_no, method=method,
                         got=absgot.tolist(), tol=tol.tolist(),
                         envelope=env.tolist(), ke_signed=float(got[2]),
                         ok=bool((absgot <= tol).all()) and overflow == 0,
                         overflow=overflow))
    com_fall = float(host(state0.pos)[:, 1].mean()
                     - host(st.pos)[:, 1].mean())
    return dict(method=method, rows=rows, com_fall=com_fall,
                seconds=time.perf_counter() - t0)


def accept(params, state0, methods=METHODS, checkpoints=CHECKPOINTS,
           device="cuda") -> dict:
    """The protocol on ``methods``: the oracle's checkpoints and each
    method's rows."""
    refs, envelopes, oracle_s = oracle_checkpoints(
        params, host(state0.pos), checkpoints)
    return dict(oracle_s=oracle_s,
                runs=[run_method(params, state0, m, refs, envelopes,
                                 checkpoints, device) for m in methods])


def failures(result: dict, com_fall: float = COM_FALL) -> list:
    """What failed: checkpoints out of tolerance or with overflow, and
    (when ``com_fall`` is set) runs whose centre of mass fell too little."""
    out = []
    for r in result["runs"]:
        out += [f"{row['method']} step {row['step']}: [tv com ke] "
                f"{row['got']} against {row['tol']}, overflow "
                f"{row['overflow']}" for row in r["rows"] if not row["ok"]]
        if com_fall is not None and not r["com_fall"] > com_fall:
            out.append(f"{r['method']}: centre of mass fell "
                       f"{r['com_fall']:.4f}, not more than {com_fall}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_accept_cont: CUDA is not available; this script needs "
              "a card", file=sys.stderr)
        return 1
    from gpufluidsimulator_torch.ops import inc
    alpha = float(sys.argv[1]) if len(sys.argv) > 1 else None
    if len(sys.argv) > 2:
        inc.RESUM_EVERY = int(sys.argv[2])
    params, state0 = scene(alpha=alpha)
    result = accept(params, state0)
    print(f"oracle (twice, {sum(CHECKPOINTS)} steps): "
          f"{result['oracle_s']:.1f} s", flush=True)
    for r in result["runs"]:
        for row in r["rows"]:
            g, t = row["got"], row["tol"]
            print(f"step {row['step']:4d} {row['method']:16s} [tv com ke] = "
                  f"[{g[0]:.4f} {g[1]:.4f} {g[2]:.4f}]  tol "
                  f"[{t[0]:.4f} {t[1]:.4f} {t[2]:.4f}]  ke "
                  f"{row['ke_signed']:+.4f}  "
                  f"{'PASS' if row['ok'] else 'FAIL'}  "
                  f"ovf={row['overflow']}", flush=True)
        print(f"{r['method']}: centre of mass fell {r['com_fall']:.4f} "
              f"(> {COM_FALL}); {r['seconds']:.1f} s", flush=True)
    bad = failures(result)
    for b in bad:
        print(f"FAILED: {b}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
