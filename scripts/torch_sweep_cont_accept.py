"""Variants of the continuity tier against the statistical acceptance.

    python3 scripts/torch_sweep_cont_accept.py [variant ...]
      variant = form:beta[:relax], e.g. sum:1.0 rate:1.0 relax:1.0:0.0625

Counterpart of ``scripts/sweep_cont_accept.py``.  Runs the float64 oracle
and its 1-ulp twin once (``torch_accept_cont.oracle_checkpoints``) and
caches their observables in a file of the temporary directory whose name
hashes the scene, the parameters and the checkpoints; then runs each
(``cont_form``, ``cont_beta``[, ``cont_relax``]) variant of
``pallas_inc_cont`` through ``torch_accept_cont.run_method`` on the card
and prints one line: each checkpoint's total variation and SIGNED
kinetic-energy gap (whether the variant pumps or damps energy), pass or
fail, the worst margin (largest gap over its tolerance) and the overflow.
Default variants: ``rate:1.0`` and ``relax:1.0``.  Imports the package
next to the scripts folder, never JAX.
"""

from __future__ import annotations

import hashlib
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from scripts import torch_accept_cont as acc  # noqa: E402


def parse(args) -> list:
    out = []
    for a in args:
        parts = a.split(":")
        relax = float(parts[2]) if len(parts) > 2 else None
        out.append((parts[0], float(parts[1]), relax))
    return out or [("rate", 1.0, None), ("relax", 1.0, None)]


def cache_path(params, n: int, checkpoints) -> str:
    key = hashlib.sha256(repr((params, n, tuple(checkpoints))).encode())
    return os.path.join(tempfile.gettempdir(),
                        f"torch_oracle_cont_obs-{key.hexdigest()[:16]}.npz")


def cached_oracle(params, state0, checkpoints=acc.CHECKPOINTS):
    """``acc.oracle_checkpoints``' observables and envelopes, from the
    cache when it is there."""
    path = cache_path(params, state0.n, checkpoints)
    k = len(checkpoints)
    if os.path.exists(path):
        z = np.load(path)
        refs = [(z[f"h{i}"], z[f"c{i}"], float(z[f"k{i}"]))
                for i in range(k)]
        return refs, list(z["env"])
    refs, envelopes, secs = acc.oracle_checkpoints(
        params, acc.host(state0.pos), checkpoints)
    np.savez(path, env=np.stack(envelopes),
             **{f"h{i}": r[0] for i, r in enumerate(refs)},
             **{f"c{i}": r[1] for i, r in enumerate(refs)},
             **{f"k{i}": r[2] for i, r in enumerate(refs)})
    print(f"oracle ({secs:.1f} s) cached -> {path}", flush=True)
    return refs, envelopes


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_sweep_cont_accept: CUDA is not available; this script "
              "needs a card", file=sys.stderr)
        return 1
    params, state0 = acc.scene()
    refs, envelopes = cached_oracle(params, state0)
    for form, beta, relax in parse(sys.argv[1:]):
        p = params.replace(cont_form=form, cont_beta=beta)
        if relax is not None:
            p = p.replace(cont_relax=relax)
        r = acc.run_method(p, state0, "pallas_inc_cont", refs, envelopes)
        line = f"{form}:b={beta:g}" + (f":l={relax:g} " if relax is not None
                                       else " ")
        worst = 0.0
        for row in r["rows"]:
            line += (f"| s{row['step']}: tv {row['got'][0]:.4f} ke "
                     f"{row['ke_signed']:+.4f}"
                     f"{' ok' if row['ok'] else ' FAIL'} ")
            worst = max([worst] + [g / t for g, t in zip(row["got"],
                                                         row["tol"])])
        print(line + f"| worst-margin {worst:.2f} "
              f"ovf={r['rows'][-1]['overflow']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
