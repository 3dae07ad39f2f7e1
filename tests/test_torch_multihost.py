"""PyTorch port: a mesh across processes.  Two local CPU processes of two
slabs each form one 4-slab mesh over gloo (``parallel.mesh
.init_distributed``), run the sharded step, and the gathered trajectory
matches the single-process run; the counterpart of
``tests/test_multihost.py``.

The children import torch and the port only.  Tolerance: positions 1e-5
after 3 steps, as the reference's test holds them; ids conserved.
"""

import os
import socket
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import os, sys
sys.path.insert(0, os.environ["FLUID_REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
import gpufluidsimulator_torch as tfs
from gpufluidsimulator_torch.parallel import mesh as meshmod
from gpufluidsimulator_torch.parallel import sharded

assert meshmod.init_distributed(device="cpu"), "init_distributed said no"
assert torch.distributed.get_world_size() == 2
mesh = meshmod.make_mesh(devices=["cpu", "cpu"])   # 2 processes x 2 slabs
assert mesh.size == 4 and len(mesh.local) == 2, mesh

params, state = tfs.scenes.dam_break(n=700, dim=2, jitter=0.2, seed=1,
                                     device="cpu")
params = params.replace(diagnostics=False)
sstate, m_cap = sharded.distribute_global(params, state, mesh)
assert sum(p is not None for p in sstate.pos) == 2
if os.environ["FLUID_METHOD"] == "pallas":
    out = sharded.run_sharded(sstate, params, mesh, n_steps=3, m_cap=m_cap)
else:
    out = sharded.run_sharded_inc(sstate, params, mesh, n_steps=3)
g = sharded.gather(out, state.n)          # all-gather; raises on a loss
assert np.array_equal(g.ids.numpy(), np.arange(state.n))
counts = torch.tensor([sum(int(o) for o in f if o is not None)
                       for f in (out.overflow, out.mig_overflow)])
torch.distributed.all_reduce(counts)
assert counts.tolist() == [0, 0], counts
# the single-process run, computed identically in every process
ref = tfs.run(state, params, 3, method="pallas", device="cpu")
rp = ref.pos.numpy()[np.argsort(ref.ids.numpy())]
err = float(np.abs(g.pos.numpy() - rp).max())
assert err < 1e-5, err
assert int(g.overflow) == 0
if torch.distributed.get_rank() == 0:
    print(f"MULTIHOST OK err={err:.2e}")
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("method", ["pallas", "pallas_inc"])
def test_two_process_cpu_matches_single(method):
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update({
            "FLUID_COORDINATOR": f"127.0.0.1:{port}",
            "FLUID_NUM_PROCESSES": "2",
            "FLUID_PROCESS_ID": str(pid),
            "FLUID_REPO": _ROOT,
            "FLUID_METHOD": method,
            "OMP_NUM_THREADS": "1",
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CHILD], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        assert rc == 0, f"child failed rc={rc}\n{out}\n{err[-3000:]}"
    assert "MULTIHOST OK" in outs[0][1]
