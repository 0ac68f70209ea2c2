"""Smoke test of the forward transport on a GPU.

Run from the repository root on a machine with one NVIDIA GPU::

    python chip_smoke.py               # phases (a)-(e), one GPU
    python chip_smoke.py --four-gpus   # the photon-sharded path on 4 GPUs

Phases, each fatal on failure:

(a) device: JAX must find a GPU; prints its ``device_kind`` and
    ``nvidia-smi``'s name and power limit (read by a child process that
    does not import JAX).
(b) main path: ``default_MCRT`` on ``res/sphere.toml`` at the config's own
    size (1,000,000 photons into a 200^3 fluence grid, emission and
    absorb grids beside it) through to its NRRD outputs; then the other
    kernels users reach, each once at its config's own size: the
    validation kernel (res/scat_test.toml, in phase (c)), escape functions
    (res/escape_test.toml) and inverse recovery (res/inverse_test.toml).
(c) physics: scat_test gives 57.5 +- 0.5 scatters per photon at 100,000
    photons; the sphere fluence of (b) agrees with the independent native
    C++ engine (``rsmcrt_tpu.native``) on total path length and radial
    profile within 5 standard errors of the difference, the standard error
    estimated from the spread of the native batches and scaled to both
    photon counts.
(d) GPU vs CPU: ``transport_step`` on the CPU device and on the GPU from
    the same state, threefry key and float32 config; reports the share of
    lanes whose ``pos``/``weight``/``layer`` agree (see ``POS_ATOL`` and
    ``MIN_AGREE`` for the tolerance and its reason).
(e) precision: the engine's small-table lookups equal ``table[idx]`` bit
    for bit; the transforms' matrix product keeps full f32 precision.

The last line of output is ``{"ok": true, "device": {...}}``, printed only
after every phase passed.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "data" / "chip_smoke"


class PhaseFailed(AssertionError):
    pass


def check(ok: bool, what: str):
    print(f"  [{'pass' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        raise PhaseFailed(what)


def gpu_identity() -> str:
    """``name, power.limit`` of every GPU, from nvidia-smi in a child
    process (the parent's JAX holds the card)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def phase_device(allow_cpu: bool = False) -> dict:
    """(a) The device JAX reports; exits non-zero without a GPU."""
    import jax

    devices = jax.devices()
    d = devices[0]
    if d.platform != "gpu" and not allow_cpu:
        print(f"chip_smoke: JAX found no GPU (platform {d.platform!r})",
              file=sys.stderr)
        sys.exit(2)
    print(f"(a) device: platform={d.platform} device_kind={d.device_kind!r}"
          f" count={len(devices)}", flush=True)
    if d.platform == "gpu":
        print("(a) nvidia-smi name, power.limit:", flush=True)
        print(gpu_identity(), flush=True)
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


def phase_main_path(config: str = "res/sphere.toml", nphotons=None):
    """(b) ``default_MCRT`` through to its NRRD outputs.  The tail-shrink
    ladder is compiled first (``engine.warmup``) so compilation and the
    run are timed apart.  Returns the SimResult."""
    import jax

    from rsmcrt_tpu.kernels import (default_MCRT, device_knobs, setup,
                                    transport_config)
    from rsmcrt_tpu.transport.engine import warmup

    parsed, scene = setup(REPO / config)
    st = parsed.settings
    cfg = transport_config(parsed, nphotons=nphotons)
    knobs = device_knobs()
    t0 = time.perf_counter()
    warmup(scene, parsed.source, st.grid, jax.random.key(0), cfg,
           bank=parsed.detectors, chunk_steps=knobs["chunk_steps"],
           min_lanes=knobs["min_lanes"])
    print(f"(b) compile (warmup of {cfg.n_lanes}-lane ladder, K="
          f"{cfg.dda_substeps}): {time.perf_counter() - t0:.1f} s",
          flush=True)

    shutil.rmtree(OUT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    res = default_MCRT(REPO / config, data_dir=OUT_DIR, nphotons=nphotons,
                       verbose=False)
    wall = time.perf_counter() - t0
    stats = jax.devices()[0].memory_stats() or {}
    print(f"(b) {config}: {res.launched} photons, grid {st.grid.shape}, "
          f"{res.steps} megasteps", flush=True)
    print(f"(b) photons/s: {res.photons_per_second:.1f} (transport "
          f"{res.elapsed:.3f} s; default_MCRT wall {wall:.3f} s)",
          flush=True)
    print(f"(b) peak_bytes_in_use: {stats.get('peak_bytes_in_use')}",
          flush=True)

    from rsmcrt_tpu.io.writer import read_nrrd

    n = cfg.nphotons
    check(res.launched == n, f"launched {res.launched} == {n}")
    jmean = np.asarray(res.tallies.jmean)
    check(jmean.shape == (int(np.prod(st.grid.shape)),)
          and bool(np.all(np.isfinite(jmean))) and jmean.sum() > 0,
          "fluence finite, positive, of the grid's size")
    for sub, name in (("jmean", st.outfile),
                      ("emission", st.rendersourcefile)):
        vol, _ = read_nrrd(OUT_DIR / sub / name)
        check(vol.shape == st.grid.shape and bool(np.all(np.isfinite(vol))),
              f"wrote {sub}/{name} {vol.shape}")
    nsc = res.nscatt_per_photon
    check(np.isfinite(nsc) and nsc > 0, f"nscatt/photon {nsc:.4f}")
    return res


def phase_other_kernels():
    """(b) The escape-function and inverse kernels at their configs'
    own sizes."""
    from rsmcrt_tpu.escape import escape_function
    from rsmcrt_tpu.inverse import inverse_MCRT

    t0 = time.perf_counter()
    escape, sym = escape_function(REPO / "res/escape_test.toml",
                                  data_dir=OUT_DIR, verbose=False)
    escape = np.asarray(escape)
    print(f"(b) escape kernel: {time.perf_counter() - t0:.1f} s, map "
          f"{escape.shape}, max {escape.max():.4g}", flush=True)
    check(bool(np.all(np.isfinite(escape))) and escape.max() > 0,
          "escape map finite and positive somewhere")

    t0 = time.perf_counter()
    best, history = inverse_MCRT(REPO / "res/inverse_test.toml",
                                 data_dir=OUT_DIR, verbose=False)
    print(f"(b) inverse kernel: {time.perf_counter() - t0:.1f} s, "
          f"{len(history)} steps, best {best}", flush=True)
    check(len(history) > 0 and all(np.isfinite(float(v))
                                   for v in best.values()),
          "inverse recovery finite")


def _radial_profile(vol: np.ndarray, grid_shape, nbins=10):
    """Mean voxel value in each of ``nbins`` spherical shells of the unit
    sphere (voxel centres of the [-1, 1]^3 grid)."""
    c = [(np.arange(n) + 0.5) / n * 2.0 - 1.0 for n in grid_shape]
    xx, yy, zz = np.meshgrid(*c, indexing="ij")
    r = np.sqrt(xx * xx + yy * yy + zz * zz).reshape(-1)
    b = np.minimum((r * nbins).astype(np.int64), nbins)
    vol = vol.reshape(-1).astype(np.float64)
    return (np.bincount(b, vol, nbins + 1)[:nbins]
            / np.bincount(b, None, nbins + 1)[:nbins])


def phase_physics(main_result, scat_photons=100_000, scat_tol=0.5,
                  native_photons=1_000_000, native_batches=16,
                  n_sigma=5.0):
    """(c) The scat_test gate and the native-oracle comparison of the
    main path's sphere fluence."""
    from rsmcrt_tpu import native
    from rsmcrt_tpu.kernels import test_kernel

    t0 = time.perf_counter()
    out = test_kernel(REPO / "res/scat_test.toml", nphotons=scat_photons,
                      end_early=False, write_files=False)
    ns = out["nscatt"]
    print(f"(c) scat_test: {scat_photons} photons, nscatt/photon "
          f"{ns:.4f} ({time.perf_counter() - t0:.1f} s)", flush=True)
    check(abs(ns - 57.5) <= scat_tol, f"nscatt {ns:.4f} = 57.5 +- {scat_tol}")

    # the native engine on the main path's scene (res/sphere.toml: mus=10,
    # mua=0.1, g=0.9, n=1.38 unit sphere in a vacuum 2^3 box, point source)
    st = main_result.parsed.settings
    shape = st.grid.shape
    prims = [native.sphere([0, 0, 0], 1.0, 10.0, 0.1, 0.9, 1.38),
             native.box([0, 0, 0], [2.0, 2.0, 2.0], 0.0, 0.0, 0.0, 1.0)]
    m = native_photons // native_batches
    t0 = time.perf_counter()
    tot_b, prof_b = [], []
    for i in range(native_batches):
        j, _ = native.run_native(prims, list(shape), [1.0] * 3, 0,
                                 [0, 0, 0], None, m, seed=1000 + i)
        tot_b.append(j.sum(dtype=np.float64) / m)
        prof_b.append(_radial_profile(j, shape) / m)
    print(f"(c) native oracle: {native_batches} x {m} photons "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    tot_b, prof_b = np.asarray(tot_b), np.asarray(prof_b)

    n_j = main_result.launched
    n_n = m * native_batches
    jm = np.asarray(main_result.tallies.jmean)
    tot_j = jm.sum(dtype=np.float64) / n_j
    prof_j = _radial_profile(jm, shape) / n_j
    # per-photon variance from the batch spread, scaled to both counts
    var_tot = m * tot_b.var(ddof=1)
    var_prof = m * prof_b.var(axis=0, ddof=1)
    se_tot = np.sqrt(var_tot / n_j + var_tot / n_n)
    se_prof = np.sqrt(var_prof / n_j + var_prof / n_n)
    dz_tot = (tot_j - tot_b.mean()) / se_tot
    dz_prof = (prof_j - prof_b.mean(axis=0)) / se_prof
    print(f"(c) path length/photon: JAX {tot_j:.6f} native "
          f"{tot_b.mean():.6f} (z = {dz_tot:+.2f})", flush=True)
    print("(c) radial profile z-scores: "
          + " ".join(f"{z:+.2f}" for z in dz_prof), flush=True)
    check(abs(dz_tot) <= n_sigma,
          f"total fluence within {n_sigma} standard errors")
    check(bool(np.all(np.abs(dz_prof) <= n_sigma)),
          f"radial profile within {n_sigma} standard errors in every shell")


def _fifty_sphere_case():
    from rsmcrt_tpu.grid import cart_grid
    from rsmcrt_tpu.scenes import setup_sphere_scene
    from rsmcrt_tpu.sdfs.scene import build_scene
    from rsmcrt_tpu.sources.sources import build_source

    scene = build_scene(setup_sphere_scene({"num_spheres": 50}))
    grid = cart_grid(200, 200, 200, 1.0, 1.0, 1.0)
    src = build_source("uniform", point1=[-1.0, -1.0, 1.0],
                       point2=[2.0, 0.0, 0.0], point3=[0.0, 2.0, 0.0],
                       direction=[0.0, 0.0, -1.0])
    return scene, grid, src


def _sphere_case():
    from rsmcrt_tpu.kernels import setup

    parsed, scene = setup(REPO / "res/sphere.toml")
    return scene, parsed.settings.grid, parsed.source


def step_states(case, device, n_lanes=4096, n_steps=4, dda_substeps=8):
    """Lane states after each of ``n_steps`` megasteps of ``case`` on
    ``device`` (same key, f32, chained walk, fluence off: every chain
    round then ends at an event, never at a voxel wall -- a lane that
    stops ON a wall can cross it in the next megastep's first round or
    not, by one ulp, and so run a voxel ahead without any physics
    difference)."""
    import jax
    import jax.numpy as jnp

    from rsmcrt_tpu.transport.engine import (TransportConfig, init_carry,
                                             transport_step)

    scene, grid, src = case
    cfg = TransportConfig(nphotons=1 << 30, n_lanes=n_lanes,
                          dda_substeps=dda_substeps, chain_scatter=True,
                          record_fluence=False)
    args = jax.device_put(
        (init_carry(grid, cfg), scene, src, grid, jax.random.key(2024)),
        device)
    carry, scene, src, grid, key = args
    step = jax.jit(lambda c, sc, so, g, k: transport_step(
        c, sc, so, g, k, cfg, jnp.int32(1 << 30)))
    out = []
    for _ in range(n_steps):
        carry = step(carry, scene, src, grid, key)
        s = carry.state
        out.append({k: np.asarray(getattr(s, k))
                    for k in ("pos", "weight", "layer", "alive")})
    return out


#: lanes agree when layer and alive match exactly, positions within this
#: distance (scene units; ~1e-3 of a 200^3 voxel and ~100 f32 ulps at the
#: unit scale) and weights within this relative difference.  f32 programs
#: on two devices differ by a few ulps in transcendentals (log, sin/cos,
#: sqrt) and fused multiply-adds.  That is far below these bounds, but it
#: can flip the branch of a lane that sits on a decision (a Fresnel draw
#: at the coefficient, HG sampling near cos = 1), and such lanes then
#: part ways: on one CPU, a 1-ulp change of every position kept 99.9%
#: (sphere) and 99.8% (50 spheres) of lanes agreeing after 4 megasteps.
#: A TF32 contraction (~1e-3 relative) on a surface normal or an optical
#: lookup moves most lanes that met a surface past the position bound.
POS_ATOL = 1e-5
WEIGHT_RTOL = 1e-5
MIN_AGREE = 0.98


def agreement(a: dict, b: dict) -> float:
    same = ((a["layer"] == b["layer"]) & (a["alive"] == b["alive"])
            & np.all(np.abs(a["pos"] - b["pos"]) <= POS_ATOL, axis=-1)
            & (np.abs(a["weight"] - b["weight"])
               <= WEIGHT_RTOL * np.maximum(np.abs(b["weight"]), 1e-30)))
    return float(same.mean())


def phase_gpu_vs_cpu(n_lanes=4096, n_steps=4, min_agree=MIN_AGREE,
                     cases=("sphere", "fifty_spheres")):
    """(d) Same megasteps on the CPU device and on the default device."""
    import jax

    cpu, dev = jax.devices("cpu")[0], jax.devices()[0]
    builders = {"sphere": _sphere_case, "fifty_spheres": _fifty_sphere_case}
    for name in cases:
        case = builders[name]()
        t0 = time.perf_counter()
        ref = step_states(case, cpu, n_lanes, n_steps)
        got = step_states(case, dev, n_lanes, n_steps)
        shares = [agreement(g, r) for g, r in zip(got, ref)]
        alive = float(got[-1]["alive"].mean())
        print(f"(d) {name}: B={n_lanes}, lanes agreeing after megasteps "
              f"1..{n_steps}: {' '.join(f'{s:.4f}' for s in shares)} "
              f"(alive {alive:.3f}; {time.perf_counter() - t0:.1f} s)",
              flush=True)
        check(shares[-1] >= min_agree,
              f"{name}: share {shares[-1]:.4f} >= {min_agree}")


def phase_precision(n_rows=(3, 52), n_lanes=4096, seed=0):
    """(e) Small-table lookups bit for bit (short tables take select
    chains, longer ones gathers), and the f32 matrix product."""
    import types

    import jax
    import jax.numpy as jnp

    from rsmcrt_tpu.maths import transforms as T
    from rsmcrt_tpu.transport import engine

    rng = np.random.default_rng(seed)
    mono = types.SimpleNamespace(wavelengths=None)
    f_opt = jax.jit(lambda a, i: engine._opt_lookup(mono, a, i, None))
    f_col = jax.jit(engine._take_col)
    for n in n_rows:
        table = rng.standard_normal(n).astype(np.float32)
        table4 = rng.standard_normal((n, 4)).astype(np.float32)
        cols = rng.standard_normal((n_lanes, n)).astype(np.float32)
        idx = rng.integers(0, n, n_lanes).astype(np.int32)
        i = jnp.asarray(idx)
        check(np.array_equal(np.asarray(f_opt(jnp.asarray(table), i)),
                             table[idx]),
              f"optical lookup [{n}] bit exact")
        check(np.array_equal(np.asarray(f_opt(jnp.asarray(table4), i)),
                             table4[idx]),
              f"optical lookup [{n}, 4] bit exact")
        check(np.array_equal(np.asarray(f_col(jnp.asarray(cols), i)),
                             cols[np.arange(n_lanes), idx]),
              f"per-lane column take of {n} bit exact")

    a = rng.standard_normal((4, 4)).astype(np.float32)
    b = rng.standard_normal((4, 4)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    got = np.asarray(jax.jit(T.matmul)(a, b), np.float64)
    rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    print(f"(e) transforms.matmul max rel error {rel:.2e}", flush=True)
    check(rel < 1e-6, "4x4 f32 matmul at full precision")


def phase_four_gpus(n_photons=4_000_000, n_lanes=65536, single_batches=8,
                    n_sigma=5.0, devices=None):
    """Photon sharding over a 4-GPU ``("dp",)`` mesh vs the same budget
    on one GPU: total fluence, nscatt/photon and the bench circle
    detector's total per photon, each within ``n_sigma`` standard errors;
    every device must launch photons.  The one-GPU reference is the same
    chunked driver on a one-device mesh, run in ``single_batches``
    independent batches whose spread gives the standard errors.
    ``n_lanes`` per device (not the device row's width) keeps each
    one-GPU batch from spending its time in a full-width straggler tail,
    which the sharded driver does not shrink."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, str(REPO))
    from bench import bench_bank, bench_config, bench_case
    from rsmcrt_tpu.detectors.detectors import totals
    from rsmcrt_tpu.parallel.mesh import make_mesh, simulate_sharded_chunked

    devices = jax.devices() if devices is None else devices
    check(len(devices) == 4, f"{len(devices)} devices visible, need 4")
    scene, grid, src = bench_case()
    cfg, kw = bench_config(fluence=True, nphotons=n_photons)
    cfg = dataclasses.replace(cfg, n_lanes=n_lanes)
    four, one = make_mesh(devices), make_mesh(devices[:1])
    last = {}

    def run(mesh, seed, n):
        def progress(launched, n_target, step, carry):
            last["launched"] = np.asarray(carry.launched)

        t, b, launched, _ = simulate_sharded_chunked(
            scene, src, grid, jax.random.key(seed), cfg, bank=bench_bank(),
            mesh=mesh, chunk_steps=kw["chunk_steps"], nphotons=n,
            progress=progress)
        launched = int(launched)
        return np.asarray([float(jnp.sum(t.jmean)) / launched,
                           float(t.nscatt) / launched,
                           float(totals(b)[0]) / launched]), launched

    for mesh in (four, one):  # compile on a small budget
        run(mesh, 0, len(mesh.devices) * n_lanes // 8)
    t0 = time.perf_counter()
    q_sh, n_sh = run(four, 1, n_photons)
    dt_sh = time.perf_counter() - t0
    per_device = last["launched"]
    print(f"(4) sharded over {len(devices)} GPUs: {n_sh} photons in "
          f"{dt_sh:.2f} s ({n_sh / dt_sh:.1f} photons/s); per-device "
          f"launched {per_device.tolist()}", flush=True)

    m = n_photons // single_batches
    t0 = time.perf_counter()
    qs = np.asarray([run(one, 100 + i, m)[0] for i in range(single_batches)])
    dt_one = time.perf_counter() - t0
    n_one = m * single_batches
    var = m * qs.var(axis=0, ddof=1)
    z = (q_sh - qs.mean(axis=0)) / np.sqrt(var / n_one + var / n_sh)
    print(f"(4) one GPU: {n_one} photons in {dt_one:.2f} s "
          f"({n_one / dt_one:.1f} photons/s)", flush=True)
    for name, a, b, zz in zip(("fluence/photon", "nscatt/photon",
                               "detector/photon"), q_sh, qs.mean(axis=0), z):
        print(f"(4) {name}: sharded {a:.6f} one-GPU {b:.6f} "
              f"(z = {zz:+.2f})", flush=True)
    check(n_sh == n_photons, f"sharded launched {n_sh} == {n_photons}")
    check(bool(np.all(per_device > 0)), "every device launched photons")
    check(bool(np.all(np.abs(z) <= n_sigma)),
          f"sharded == one GPU within {n_sigma} standard errors")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-GPU photon-sharded comparison")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))

    t_start = time.perf_counter()
    info = phase_device()
    if args.four_gpus:
        phase_four_gpus()
    else:
        res = phase_main_path()
        phase_other_kernels()
        phase_physics(res)
        phase_gpu_vs_cpu()
        phase_precision()
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
