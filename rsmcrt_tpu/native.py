"""ctypes bindings for the native CPU MCRT engine (native/mcrt.cpp).

The native engine is an independent scalar implementation of the same
physics used for cross-validation of the JAX wavefront engine and as the
CPU baseline in benchmarks (the role OpenMP plays in the reference).
The shared library is built from the source at first use.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
_SRC_PATH = _NATIVE_DIR / "mcrt.cpp"
_LIB_PATH = _NATIVE_DIR / "libmcrt.so"
CXXFLAGS = ["-O3", "-march=native", "-fopenmp", "-fPIC", "-std=c++17",
            "-shared"]

_lib = None


def build(lib_path: Path = _LIB_PATH) -> Path:
    """Compile ``native/mcrt.cpp`` into ``lib_path``.  The library is
    written under a per-process temporary name and renamed into place,
    so concurrent builders (parallel test workers) never load a partial
    file."""
    tmp = lib_path.with_name(f"{lib_path.name}.tmp{os.getpid()}")
    errors = []
    # $CXX first, then the system compilers (a toolchain named by $CXX
    # may lack OpenMP)
    for cxx in dict.fromkeys(filter(None, (os.environ.get("CXX"),
                                           shutil.which("g++"),
                                           shutil.which("c++")))):
        try:
            run = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp),
                                  str(_SRC_PATH)],
                                 capture_output=True, text=True)
        except OSError as e:
            errors.append(f"{cxx}: {e}")
            continue
        if run.returncode == 0:
            os.replace(tmp, lib_path)
            return lib_path
        tmp.unlink(missing_ok=True)
        errors.append(f"{cxx}: {run.stderr.strip()[-2000:]}")
    raise RuntimeError("cannot build the native engine:\n"
                       + "\n".join(errors or ["no C++ compiler found"]))


def _ensure_built():
    global _lib
    if _lib is not None:
        return _lib
    if (not _LIB_PATH.exists()
            or _LIB_PATH.stat().st_mtime < _SRC_PATH.stat().st_mtime):
        build()
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.mcrt_run.restype = ctypes.c_double
    lib.mcrt_run.argtypes = [
        ctypes.POINTER(ctypes.c_double),  # prims
        ctypes.c_int,  # n_prims
        ctypes.POINTER(ctypes.c_int),  # grid_n
        ctypes.POINTER(ctypes.c_double),  # grid_max
        ctypes.c_int,  # source kind
        ctypes.POINTER(ctypes.c_double),  # spos
        ctypes.POINTER(ctypes.c_double),  # sdir
        ctypes.c_long,  # nphotons
        ctypes.c_uint64,  # seed
        ctypes.POINTER(ctypes.c_float),  # jmean
        ctypes.c_int,  # n_threads
    ]
    lib.mcrt_num_threads.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    try:
        _ensure_built()
        return True
    except Exception:
        return False


def sphere(centre, radius, mus, mua, g, n):
    return [0.0, *centre, radius, 0.0, 0.0, 0.0, mus, mua, g, n]


def box(centre, lengths, mus, mua, g, n):
    half = [0.5 * v for v in lengths]
    return [1.0, *centre, 0.0, *half, mus, mua, g, n]


def egg(centre, r1, r2, h, mus, mua, g, n):
    """Moss egg (reference sdfs.f90:688-718): base radius r1, top radius
    r2, top-circle height h."""
    return [2.0, *centre, r1, r2, h, 0.0, mus, mua, g, n]


def egg_shell(centre, r1, r2, h, thickness, mus, mua, g, n):
    """onion(egg, thickness): the egg-shell modifier composition used to
    cross-validate modifier transport."""
    return [3.0, *centre, r1, r2, h, thickness, mus, mua, g, n]


def run_native(prims, grid_n, grid_max, source_kind, spos, sdir, nphotons,
               seed=1234, n_threads=0):
    """Run the native engine.  ``prims`` is a list of :func:`sphere` /
    :func:`box` rows.  Returns (jmean volume [nx,ny,nz], nscatt total)."""
    lib = _ensure_built()
    prims_flat = np.asarray(prims, np.float64).reshape(-1)
    gn = np.asarray(grid_n, np.int32)
    gm = np.asarray(grid_max, np.float64)
    sp = np.asarray(spos, np.float64)
    sd = np.asarray(sdir if sdir is not None else [0.0, 0.0, 1.0],
                    np.float64)
    jmean = np.zeros(int(gn[0] * gn[1] * gn[2]), np.float32)
    nscatt = lib.mcrt_run(
        prims_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(prims),
        gn.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        gm.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(source_kind),
        sp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        sd.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(nphotons),
        int(seed),
        jmean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(n_threads),
    )
    return jmean.reshape(int(gn[0]), int(gn[1]), int(gn[2])), float(nscatt)
