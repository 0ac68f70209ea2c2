"""Device-independent gates of the GPU translation: the per-device knob
table, the compile-cache location, exact f32 contractions in the
megastep, and the fluence deposit against exact path lengths."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rsmcrt_tpu import kernels
from rsmcrt_tpu.grid import cart_grid
from rsmcrt_tpu.maths import transforms as T
from rsmcrt_tpu.optics.properties import mono
from rsmcrt_tpu.sdfs import scene as S
from rsmcrt_tpu.sources.sources import build_source
from rsmcrt_tpu.transport.engine import (
    TransportConfig, init_carry, simulate, transport_step)

REPO = pathlib.Path(__file__).resolve().parents[1]


# --- the device table ------------------------------------------------------

@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 80GB HBM3",
                                  "Unknown Accelerator 9000"])
def test_device_knobs(kind):
    if kind not in kernels.DEVICE_TABLE:
        with pytest.raises(ValueError, match=kind):
            kernels.device_knobs(kind)
        with pytest.raises(ValueError, match=kind):
            kernels.fast_path_defaults(device_kind=kind)
        return
    row = kernels.device_knobs(kind)
    assert set(row) == {"lanes", "dda_substeps", "chain_respawns",
                        "chunk_steps", "min_lanes", "bench_photons",
                        "bench_photons_fluenceless"}
    assert kernels.default_lanes(1 << 30, kind) == row["lanes"]
    assert kernels.fast_path_defaults(False, kind) == {
        "chain_scatter": True, "dda_substeps": row["dda_substeps"],
        "chain_respawns": row["chain_respawns"]}
    # fluence runs host one photon per lane per megastep
    assert kernels.fast_path_defaults(True, kind)["chain_respawns"] == 1
    if kind == "cpu":
        assert kernels.device_knobs() is row  # the tests run on the CPU


# --- the compile cache -----------------------------------------------------

@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(env_dir, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, rsmcrt_tpu; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=tmp_path, capture_output=True, text=True, check=True,
    ).stdout.strip()
    want = (str(REPO / ".jax_cache") if env_dir is None
            else str(tmp_path / env_dir))
    assert out == want


# --- exact f32 contractions ------------------------------------------------

def _sub_jaxprs(value):
    for v in (value if isinstance(value, (list, tuple)) else (value,)):
        if hasattr(v, "eqns"):
            yield v
        elif hasattr(getattr(v, "jaxpr", None), "eqns"):
            yield v.jaxpr


def _dot_generals(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for value in eqn.params.values():
            for sub in _sub_jaxprs(value):
                yield from _dot_generals(sub)


def _ten_prim_scene():
    """Nine spheres with their own optical rows inside a box: more than 8
    prims and optical rows, and a multi-member raycast group."""
    prims = [
        S.sphere(0.2, mono(5.0 + i, 0.1 * (i + 1), 0.5, 1.3 + 0.02 * i),
                 i + 1, transform=T.invert(T.translate(
                     [0.5 * (i % 3 - 1), 0.5 * (i // 3 - 1), 0.0])))
        for i in range(9)
    ]
    prims.append(S.box([2.0, 2.0, 2.0], mono(1.0, 0.05, 0.0, 1.0), 10))
    return S.build_scene(prims)


def _sphere_scene():
    return S.build_scene([
        S.sphere(1.0, mono(10.0, 0.1, 0.9, 1.38), 1),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2),
    ])


@pytest.mark.parametrize("case", ["sphere", "ten_prims"])
def test_megastep_has_no_default_precision_f32_dot(case):
    """One bench megastep (the product fast-path config) holds no f32
    dot_general at default precision: on a GPU that would run in TF32."""
    scene = _sphere_scene() if case == "sphere" else _ten_prim_scene()
    grid = cart_grid(16, 16, 16, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.1])
    cfg = TransportConfig(nphotons=1024, n_lanes=64, record_emission=True,
                          record_moments=case != "sphere",
                          **kernels.fast_path_defaults())
    carry = init_carry(grid, cfg)
    jaxpr = jax.make_jaxpr(
        lambda c: transport_step(c, scene, src, grid, jax.random.key(0),
                                 cfg, jnp.int32(1024)))(carry)
    bad = []
    for eqn in _dot_generals(jaxpr.jaxpr):
        f32 = any(v.aval.dtype == jnp.float32 for v in eqn.invars)
        prec = eqn.params.get("precision")
        prec = prec if isinstance(prec, tuple) else (prec, prec)
        if f32 and not all(
                p == jax.lax.Precision.HIGHEST for p in prec):
            bad.append(str(eqn))
    assert not bad, bad


# --- the fluence deposit ---------------------------------------------------

N_VOX = 8
GRID = cart_grid(N_VOX, N_VOX, N_VOX, 1.0, 1.0, 1.0)


def _exact_path(origin, direction, t_end):
    """Independent reference: (flat voxel, length) pairs of a straight
    ray from ``origin`` over [0, t_end], by sorting every voxel-wall
    crossing of the ray (no DDA)."""
    o = np.asarray(origin, np.float64)
    d = np.asarray(direction, np.float64)
    d = d / np.linalg.norm(d)
    dv = 2.0 / N_VOX
    ts = [0.0, t_end]
    for a in range(3):
        if d[a] != 0.0:
            walls = -1.0 + dv * np.arange(N_VOX + 1)
            t = (walls - o[a]) / d[a]
            ts.extend(t[(t > 0.0) & (t < t_end)])
    ts = np.sort(np.asarray(ts))
    mids = 0.5 * (ts[1:] + ts[:-1])
    cells = np.floor((o[None] + mids[:, None] * d[None] + 1.0) / dv)
    cells = cells.astype(np.int64)
    inside = np.all((cells >= 0) & (cells < N_VOX), axis=1)
    flat = (cells[:, 0] * N_VOX + cells[:, 1]) * N_VOX + cells[:, 2]
    return flat[inside], np.diff(ts)[inside]


def _box_exit(origin, direction, half):
    o = np.asarray(origin, np.float64)
    d = np.asarray(direction, np.float64)
    d = d / np.linalg.norm(d)
    half = np.asarray(half, np.float64)
    with np.errstate(divide="ignore"):
        t = np.where(d > 0, (half - o) / d,
                     np.where(d < 0, (-half - o) / d, np.inf))
    return float(t.min())


# (source kind, origin or sheet corner, direction, medium half extents)
RAYS = {
    # along +z through one voxel column, leaving at the grid edge
    "axis": ("pencil", [0.1, -0.3, -0.9], [0.0, 0.0, 1.0], [1.0] * 3),
    # oblique: crosses walls on all three axes
    "diagonal": ("pencil", [-0.8, -0.7, -0.9], [0.5, 0.4, 0.7],
                 [1.0] * 3),
    # the medium ends mid-grid (and mid-voxel): the ray dies there
    "mid_grid": ("pencil", [0.1, 0.1, -0.5], [0.2, 0.1, 1.0],
                 [1.0, 1.0, 0.55]),
    # a sheet of parallel rays inside one voxel column: every photon
    # collides in the same voxels in the same megastep
    "collide": ("uniform", [0.27, 0.27, -0.9], [0.0, 0.0, 1.0], [1.0] * 3),
}


@pytest.mark.parametrize("case", sorted(RAYS))
def test_deposit_exact_path_lengths(case):
    kind, origin, direction, half = RAYS[case]
    n = 300
    scene = S.build_scene([
        S.box([2 * h for h in half], mono(0.0, 0.0, 0.0, 1.0), 1),
    ])
    if kind == "pencil":
        src = build_source("pencil", position=origin, direction=direction)
    else:
        # uniform sheet [0.27, 0.47]^2 at z=-0.9: all in voxel (5, 5)
        src = build_source("uniform", point1=origin,
                           point2=[0.2, 0.0, 0.0], point3=[0.0, 0.2, 0.0],
                           direction=direction)
    cfg = TransportConfig(nphotons=n, n_lanes=64,
                          **kernels.fast_path_defaults())
    tallies, _, launched, _ = simulate(scene, src, GRID, jax.random.key(3),
                                       cfg, chunk_steps=64)
    assert int(launched) == n

    # every photon of the case walks the same voxels with the same
    # lengths; np.add.at accumulates the n colliding deposits
    flat, length = _exact_path(origin, direction,
                               _box_exit(origin, direction, half))
    want = np.zeros(N_VOX ** 3)
    np.add.at(want, np.tile(flat, n), np.tile(length, n))
    got = np.asarray(tallies.jmean, np.float64)
    # the crossing nudge at the exit face adds ~2 eps of path
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=n * 5e-5)
    assert np.count_nonzero(got) == len(flat)
