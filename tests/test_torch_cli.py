"""PyTorch port: the command line (``python -m gpufluidsimulator_torch``)
and the native engine, on the CPU.

The CLI cases mirror ``tests/test_cli.py`` one by one, with ``--device
cpu`` and at most 400 particles.  ``FluidSim(method="native")`` is held
against the reference's ``oracle.native.run`` on the same inputs within
1e-6 (both step the same C++ engine in float64; the port's build may
differ from the committed library in its compiler flags' target, and the
state comes back as float32).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gpufluidsimulator_tpu as jfs
from gpufluidsimulator_tpu.oracle import native as jnative

import gpufluidsimulator_torch as tfs
from gpufluidsimulator_torch.models import solver as tsolver
from gpufluidsimulator_torch.utils import checkpoint as tckpt
from gpufluidsimulator_torch.utils import metrics as tmetrics
from gpufluidsimulator_torch.utils.cli import main

REPO = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]
BENCH_KEYS = {"metric", "scene", "n", "dim", "method", "ms_per_frame",
              "steps_per_sec", "value"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share the host: one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _json_line(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


def test_run_small(tmp_path, capsys):
    mj = str(tmp_path / "m.json")
    rc = main(["run", "-n", "300", "--dim", "2", "--steps", "40",
               "--report-every", "20", "--method", "naive",
               "--metrics-json", mj, *CPU])
    assert rc == 0
    out = capsys.readouterr().out
    assert "steps/s" in out and "method=naive" in out
    m = json.load(open(mj))
    assert m["steps"] == 40
    assert m["n_particles"] >= 200
    assert _json_line(out)["overflow"] == 0


def test_run_frames_and_checkpoints(tmp_path):
    frames = str(tmp_path / "frames")
    ckpts = str(tmp_path / "ckpts")
    rc = main(["run", "-n", "200", "--dim", "2", "--steps", "20",
               "--report-every", "10", "--method", "naive",
               "--frames-dir", frames, "--width", "64", "--height", "64",
               "--checkpoint-dir", ckpts, *CPU])
    assert rc == 0
    assert len(os.listdir(frames)) == 2
    assert any(f.endswith(".npz") for f in os.listdir(ckpts))


def test_run_movie_export(tmp_path, capsys):
    mv = str(tmp_path / "movie.npz")
    rc = main(["run", "-n", "300", "--dim", "2", "--steps", "30",
               "--method", "naive", "--movie", mv, "--movie-every", "10",
               *CPU])
    assert rc == 0
    assert "3 frames" in capsys.readouterr().out
    with np.load(mv) as z:
        assert z["frames"].shape[0] == 3
        assert z["frames"].shape[2] == 2
        assert int(z["every"]) == 10
        assert np.isfinite(z["frames"]).all()


def test_run_resume(tmp_path, capsys):
    ckpts = str(tmp_path / "ckpts")
    main(["run", "-n", "200", "--dim", "2", "--steps", "10",
          "--report-every", "10", "--method", "naive",
          "--checkpoint-dir", ckpts, *CPU])
    latest = tckpt.latest(ckpts)
    rc = main(["run", "--steps", "10", "--report-every", "10",
               "--method", "naive", "--resume", latest, *CPU])
    assert rc == 0
    assert "resumed" in capsys.readouterr().out


@pytest.mark.parametrize("method", ["naive", "pallas", "pallas_inc",
                                    "pallas_inc_cont"])
def test_bench_json(capsys, method):
    rc = main(["bench", "-n", "300", "--dim", "2", "--method", method,
               "--k1", "1", "--k2", "3", *CPU])
    assert rc == 0
    d = _json_line(capsys.readouterr().out)
    assert set(d) == BENCH_KEYS
    assert d["value"] > 0 and d["ms_per_frame"] > 0
    assert d["metric"] == "particle-steps/sec/chip"
    assert d["method"] == method and d["n"] == 288


def test_render_from_checkpoint(tmp_path, capsys):
    ckpts = str(tmp_path / "ckpts")
    main(["run", "-n", "200", "--dim", "2", "--steps", "10",
          "--report-every", "10", "--method", "naive",
          "--checkpoint-dir", ckpts, *CPU])
    out = str(tmp_path / "f.png")
    rc = main(["render", tckpt.latest(ckpts), "-o", out,
               "--width", "64", "--height", "64", *CPU])
    assert rc == 0
    assert open(out, "rb").read(8) == b"\x89PNG\r\n\x1a\n"


def test_param_overrides(capsys):
    rc = main(["bench", "-n", "200", "--dim", "2", "--method", "naive",
               "--viscosity", "1.5", "--k1", "1", "--k2", "2", *CPU])
    assert rc == 0


def test_run_spawn_boxes_cli(capsys):
    rc = main(["run", "--scene", "spawn_boxes", "-n", "400", "--dim", "2",
               "--steps", "10", "--report-every", "10", "--method", "naive",
               "--box", "0.0,0.0:1.0,0.25",
               "--box", "0.4,0.6:0.6,0.8:0.5,-1.0", *CPU])
    assert rc == 0
    assert "scene=spawn_boxes" in capsys.readouterr().out


def test_spawn_boxes_velocity_applied():
    params, state = tfs.scenes.spawn_boxes(
        n=400, dim=2,
        boxes=[((0.0, 0.0), (1.0, 0.25)),
               ((0.4, 0.6), (0.6, 0.8), (0.5, -1.0))], device="cpu")
    v = state.vel.numpy()
    p = state.pos.numpy()
    upper = p[:, 1] > 0.5
    assert upper.any() and (~upper).any()
    assert np.allclose(v[upper], [0.5, -1.0])
    assert np.allclose(v[~upper], 0.0)


def test_spawn_boxes_default_scene():
    rc = main(["run", "--scene", "spawn_boxes", "-n", "300", "--dim", "2",
               "--steps", "5", "--report-every", "5", "--method", "naive",
               *CPU])
    assert rc == 0


def test_box_requires_spawn_boxes():
    with pytest.raises(SystemExit):
        main(["run", "--scene", "dam_break", "-n", "100", "--dim", "2",
              "--steps", "1", "--box", "0,0:1,1", "--method", "naive",
              *CPU])


def test_sharded_movie_refused(tmp_path):
    with pytest.raises(SystemExit, match="mutually exclusive"):
        main(["run", "-n", "200", "--dim", "2", "--steps", "10",
              "--method", "naive", "--sharded",
              "--movie", str(tmp_path / "m.npz"), *CPU])


@pytest.mark.parametrize("cmd", ["run", "bench"])
def test_sharded_refused(cmd, capsys):
    """--sharded is no longer refused.  ``run --sharded`` steps a
    ShardedSim (one slab on the host with --device cpu) and ends where
    the same ShardedSim does; ``bench --sharded`` ignores the flag and
    times one device, as the reference's does."""
    from gpufluidsimulator_torch.parallel import mesh as tmesh
    from gpufluidsimulator_torch.parallel import sharded as tsh
    if cmd == "bench":
        rc = main(["bench", "-n", "200", "--dim", "2", "--method",
                   "pallas_inc", "--k1", "1", "--k2", "3", "--sharded",
                   *CPU])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0 and set(line) == BENCH_KEYS
        assert line["method"] == "pallas_inc"
        return
    rc = main(["run", "-n", "300", "--dim", "2", "--steps", "6",
               "--report-every", "3", "--method", "pallas_inc",
               "--sharded", *CPU])
    out = capsys.readouterr().out
    assert rc == 0 and "method=sharded-pallas_inc x1" in out
    final = json.loads(out.strip().splitlines()[-1])
    params, state = tfs.scenes.dam_break(n=300, dim=2, device="cpu")
    sim = tsh.ShardedSim(params, state, method="pallas_inc",
                         mesh=tmesh.make_mesh(devices=["cpu"]))
    sim.step(3)
    sim.step(3)
    want = tmetrics.invariants(sim.gather(), params)
    for key in ("kinetic_energy", "potential_energy", "vmax", "overflow",
                "nan"):
        assert final[key] == want[key], key


def test_default_device_is_the_card(monkeypatch):
    """Without --device the CLI runs on the card, and without one it
    raises instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["bench", "-n", "200", "--dim", "2", "--method", "naive"])


def test_run_profile_dir(tmp_path, capsys):
    pd = str(tmp_path / "trace")
    rc = main(["run", "-n", "200", "--dim", "2", "--steps", "5",
               "--report-every", "5", "--method", "naive",
               "--profile-dir", pd, *CPU])
    assert rc == 0
    assert "profiler trace" in capsys.readouterr().out
    found = [f for _, _, files in os.walk(pd) for f in files
             if f.endswith(".json.gz")]
    assert found, f"no trace artifacts under {pd}"


def test_module_entry_point(tmp_path):
    """``python -m gpufluidsimulator_torch`` reaches the same main."""
    out = subprocess.run(
        [sys.executable, "-m", "gpufluidsimulator_torch", "bench", "-n",
         "200", "--dim", "2", "--method", "naive", "--k1", "1", "--k2",
         "2", *CPU], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert set(_json_line(out.stdout)) == BENCH_KEYS


def test_run_native_method(capsys):
    rc = main(["run", "-n", "200", "--dim", "2", "--steps", "20",
               "--report-every", "10", "--method", "native", *CPU])
    assert rc == 0
    assert "method=native" in capsys.readouterr().out


def test_bench_native_method(capsys):
    rc = main(["bench", "-n", "300", "--dim", "2", "--method", "native",
               "--k1", "1", "--k2", "3", *CPU])
    assert rc == 0
    d = _json_line(capsys.readouterr().out)
    assert set(d) == BENCH_KEYS
    assert d["method"] == "native" and d["value"] > 0


@pytest.mark.parametrize("scene,dim,n", [("dam_break", 2, 300),
                                         ("double_dam_break", 3, 400)])
def test_fluidsim_native_matches_reference(scene, dim, n):
    """The port's own build of the engine steps like the reference's
    binding of it; the state is float32 on the FluidSim's device, ids
    untouched, positions back in spawn order."""
    jp, js = jfs.scenes.SCENES[scene](n=n, dim=dim, jitter=0.2, seed=7)
    tp, ts = tfs.scenes.SCENES[scene](n=n, dim=dim, jitter=0.2, seed=7,
                                      device="cpu")
    assert np.array_equal(ts.pos.numpy(), np.asarray(js.pos))
    sim = tfs.FluidSim(tp, ts, method="native", device="cpu")
    assert sim.method == "native"
    sim.step(15)
    p_ref, v_ref, r_ref, _ = jnative.run(
        np.asarray(js.pos, np.float64), np.asarray(js.vel, np.float64),
        jp, 15)
    for got, want in ((sim.state.pos, p_ref), (sim.state.vel, v_ref),
                      (sim.state.rho, r_ref)):
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        scale = max(np.abs(want).max(), 1.0)
        assert np.abs(got.numpy() - want).max() <= 1e-6 * scale
    assert torch.equal(sim.state.ids, ts.ids)
    assert int(sim.state.overflow) == 0
    np.testing.assert_allclose(sim.get_positions(), p_ref.astype(np.float32),
                               rtol=0, atol=1e-6)


def test_native_is_facade_only():
    """As in the reference, the registry refuses 'native' with ValueError:
    it steps on the host, outside the method table."""
    tp, ts = tfs.scenes.dam_break(n=100, dim=2, device="cpu")
    for call in (lambda: tsolver.resolve_method("native", ts.n),
                 lambda: tfs.step(ts, tp, method="native", device="cpu"),
                 lambda: tfs.run(ts, tp, 2, method="native", device="cpu"),
                 lambda: tfs.rollout(ts, tp, 2, method="native",
                                     device="cpu")):
        with pytest.raises(ValueError, match="native"):
            call()
    with pytest.raises(ValueError):
        jfs.models.solver.resolve_method("native", ts.n)
