"""ctypes binding of the native C++ CPU engine (``csrc/fluidcore.cpp``).

Counterpart: ``gpufluidsimulator_tpu/oracle/native.py``, with the same
``fluid_steps`` signature and ``run`` semantics (the NumPy oracle's
physics in float64, multithreaded, all-pairs or cell-list neighbours).

The engine is built at first use with ``g++`` and the flags of
``csrc/Makefile`` into ``gpufluidsimulator_torch/build/`` (git-ignored),
under a name that hashes the source, the flags and what ``-march=native``
means on this host, so a library built on another machine is never
loaded.  The committed ``csrc/libfluidcore.so`` is neither rebuilt nor
loaded.  ``available()`` says whether the build and load succeeded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "fluidcore.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]


def _target() -> bytes:
    """What ``-march=native`` selects on this host (ISA and tuning)."""
    out = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                         capture_output=True, check=True, timeout=60)
    return out.stdout


def build() -> Path:
    """Compile ``csrc/fluidcore.cpp`` (unless this source, these flags and
    this host's target are built already); return the library's path.
    Raises ``RuntimeError`` when ``g++`` fails."""
    try:
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
        h.update(_target())
        h.update(SOURCE.read_bytes())
        lib_path = BUILD_DIR / f"libfluidcore-{h.hexdigest()[:16]}.so"
        if lib_path.exists():
            return lib_path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        out = subprocess.run(
            ["g++", *CXX_FLAGS, "-shared", "-o", str(tmp), str(SOURCE),
             "-lpthread"], capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as err:
        raise RuntimeError(f"cannot build {SOURCE}: {err}") from err
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{out.stderr}")
    os.replace(tmp, lib_path)          # atomic: concurrent builds agree
    return lib_path


@functools.cache
def _library() -> Tuple[Optional[ctypes.CDLL], str]:
    """(the bound library, "") or (None, why it is not there)."""
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError) as err:
        return None, str(err)
    lib.fluid_steps.restype = ctypes.c_int
    lib.fluid_steps.argtypes = [
        ctypes.POINTER(ctypes.c_double)] * 4 + [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ] + [ctypes.c_double] * 6 + [
        ctypes.POINTER(ctypes.c_double)] * 3 + [
        ctypes.c_double, ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_double),
    ]
    return lib, ""


def available() -> bool:
    return _library()[0] is not None


def unavailable_reason() -> str:
    return _library()[1]


def _obs_array(params) -> np.ndarray:
    rows = []
    for ob in params.obstacles:
        kind = 0.0 if ob[0] == "box" else 1.0
        center = list(ob[1]) + [0.0] * (3 - len(ob[1]))
        if ob[0] == "sphere":
            extra = [ob[2], 0.0, 0.0]
        else:
            extra = list(ob[2]) + [0.0] * (3 - len(ob[2]))
        rows.append([kind] + center + extra)
    return np.asarray(rows, np.float64).reshape(-1, 7)


def run(pos, vel, params, n_steps: int, use_grid: bool = True
        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Advance ``n_steps`` in the native engine on the host; numpy in,
    float64 numpy (pos, vel, rho, pres) out."""
    lib, why = _library()
    if lib is None:
        raise RuntimeError(f"native fluidcore unavailable: {why}")
    pos = np.ascontiguousarray(pos, np.float64).copy()
    vel = np.ascontiguousarray(vel, np.float64).copy()
    n, dim = pos.shape
    rho = np.zeros(n, np.float64)
    pres = np.zeros(n, np.float64)
    grav = np.asarray(params.gravity, np.float64)
    lo = np.asarray(params.bounds_min, np.float64)
    hi = np.asarray(params.bounds_max, np.float64)
    obs = _obs_array(params)

    def p64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    rc = lib.fluid_steps(
        p64(pos), p64(vel), p64(rho), p64(pres),
        n, n_steps, 1 if use_grid else 0, dim,
        params.h, params.rest_density, params.stiffness, params.viscosity,
        params.particle_mass, params.dt,
        p64(grav), p64(lo), p64(hi), params.restitution,
        1 if params.clamp_negative_pressure else 0,
        1 if params.eos == "tait" else 0, params.tait_gamma,
        obs.shape[0], p64(obs))
    if rc != 0:
        raise RuntimeError(f"fluid_steps failed: rc={rc}")
    return pos, vel, rho, pres
