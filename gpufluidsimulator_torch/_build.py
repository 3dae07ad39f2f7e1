"""Build and bind the hand-written CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` for ``sm_90a`` (Hopper) at first use,
one ``nvcc -c`` per source, all started together, then linked into one
shared library with a plain C interface that ``ctypes`` loads.  Nothing is
prebuilt: the library lands in ``gpufluidsimulator_torch/build/`` under a
name that hashes the sources and flags, so an edit rebuilds it.

Every C entry point takes its pointers and the CUDA stream as
``c_void_p``, launches on that stream without synchronising, and returns
``cudaGetLastError()``; ``launch`` raises on a non-zero code and counts the
launch in ``launches``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C entry point -> argument types (the trailing stream included)
SIGNATURES = {
    "fk_occ_rowmax": [_P, _P, _I, _L, _L, _P],
    "fk_place": [_P, _P, _P, _P, _I, _I, _I, _L, _P],
    "fk_density": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _L, _F, _F,
                   _P],
    "fk_force": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _L,
                 _F, _F, _F, _F, _I, _F, _F, _F, _F, _I, _P],
    "fk_gather": [_P, _P, _P, _I, _I, _L, _P],
}

# kernel name -> launches since the last reset (a plain count per wrapper;
# chip_smoke.py zeroes it before a run and reads it after)
launches = {"occ_rowmax": 0, "place": 0, "density": 0, "force": 0,
            "gather": 0}

# the last build's compiler output (register / spill report of -Xptxas -v)
build_log = {"text": "", "seconds": 0.0, "path": ""}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build() -> Path:
    """Compile the kernels (if this exact source set is not built yet) and
    return the shared library's path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libfluidkernels-{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        build_log["path"] = str(lib_path)
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = lib_path.with_suffix(f".{tag}.tmp")
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib_path)
    build_log.update(text="\n".join(log), path=str(lib_path),
                     seconds=time.perf_counter() - t0)
    return lib_path


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.fk_error_string.argtypes = [ctypes.c_int]
    lib.fk_error_string.restype = ctypes.c_char_p
    return lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype/shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(kernel: str, like: torch.Tensor, *args) -> None:
    """Call C entry ``fk_<kernel>`` on ``like``'s device and current stream;
    raise on a launch error; count the launch."""
    lib = library()
    with torch.cuda.device(like.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        err = getattr(lib, f"fk_{kernel}")(*args, stream)
    if err != 0:
        msg = lib.fk_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"error {err} ({msg})")
    launches[kernel] += 1
