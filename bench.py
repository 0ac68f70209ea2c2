"""Headline benchmark: photons/s on the sphere scene.

Prints ONE JSON line naming the device it ran on:
  {"metric": ..., "value": N, "unit": "photons/s", "platform": ...,
   "device_kind": ..., "device_count": N, ...}

Scene: mus=10, mua=0.1, g=0.9, n=1.38 sphere of radius 1 in a vacuum
bounding box, point source at the centre, 200^3 fluence grid
(res/sphere.toml).  Lanes, K, C, chunk length, tail width and photon
budgets come from the device's row of ``kernels.DEVICE_TABLE``, the same
row the product kernels use.  The bench runs on a GPU; ``--cpu`` asks
for the CPU explicitly (a CPU rate is not a device rate).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp


def require_gpu(allow_cpu: bool = False) -> dict:
    """The device record for every output line; exits if JAX found no
    GPU and the CPU was not asked for."""
    devices = jax.devices()
    info = {"platform": devices[0].platform,
            "device_kind": devices[0].device_kind,
            "device_count": len(devices)}
    if info["platform"] != "gpu" and not allow_cpu:
        raise SystemExit(f"bench.py: no GPU found ({info}); pass --cpu to "
                         f"run on the CPU")
    return info


def bench_case(dtype=None):
    """The headline benchmark scene/grid/source (res/sphere.toml), shared
    with the profiling tools so they stay comparable."""
    from rsmcrt_tpu.grid import cart_grid
    from rsmcrt_tpu.optics.properties import mono
    from rsmcrt_tpu.sdfs import scene as S
    from rsmcrt_tpu.sources.sources import build_source

    scene = S.build_scene([
        S.sphere(1.0, mono(10.0, 0.1, 0.9, 1.38), 1),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2),
    ])
    grid = cart_grid(200, 200, 200, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.0])
    return scene, grid, src


def bench_bank():
    """A circle detector inside the bench box (``--detector`` and the
    fluenceless cell)."""
    from rsmcrt_tpu.detectors.detectors import (CircleDetectors,
                                                DetectorBank)

    arr = lambda v: jnp.asarray(v, jnp.float32)
    circ = CircleDetectors(
        pos=arr([[0.0, 0.0, 0.8]]), dir=arr([[0.0, 0.0, -1.0]]),
        radius=arr([1.0]), bin_wid=arr([1.0 / 32]),
        data=jnp.zeros((1, 33), jnp.float32), nbins=32,
    )
    return DetectorBank(
        circle=circ, annulus=None, fibre=None, camera=None,
        target_values=jnp.full((1,), -1.0), order=(("circle", 0),),
        ids=("d0",), layers=(2,),
    )


def bench_config(fluence: bool = True, nphotons=None):
    """(TransportConfig, simulate kwargs) of a bench cell, built from the
    device row exactly as ``kernels.run_MCRT`` builds the product run.
    The fluenceless cell is the path-length estimator OFF regime of
    escape-function / detector / inverse runs (reference without
    -Dpathlength, inttau2.f90:446-462)."""
    from rsmcrt_tpu.kernels import (default_lanes, device_knobs,
                                    fast_path_defaults)
    from rsmcrt_tpu.transport.engine import TransportConfig

    knobs = device_knobs()
    n = int(nphotons or knobs["bench_photons" if fluence
                              else "bench_photons_fluenceless"])
    cfg = TransportConfig(nphotons=n, n_lanes=default_lanes(n),
                          record_fluence=fluence, record_emission=fluence,
                          **fast_path_defaults(fluence=fluence))
    return cfg, {"chunk_steps": knobs["chunk_steps"],
                 "min_lanes": knobs["min_lanes"]}


def run_cell(fluence: bool = True, with_detector: bool = False,
             nphotons=None):
    """Warm up, then time one full simulation; returns (photons/s,
    tallies, detector bank)."""
    from rsmcrt_tpu.transport.engine import simulate, warmup

    scene, grid, src = bench_case()
    bank = bench_bank() if with_detector else None
    cfg, kw = bench_config(fluence, nphotons)
    # compile every program of the tail-shrink ladder before timing
    warmup(scene, src, grid, jax.random.key(0), cfg, bank=bank, **kw)
    t0 = time.perf_counter()
    tallies, bank_out, launched, _ = simulate(
        scene, src, grid, jax.random.key(1), cfg, bank=bank, **kw)
    jax.block_until_ready((tallies, bank_out))
    dt = time.perf_counter() - t0
    return int(launched) / dt, tallies, bank_out


def main_sharded(info):
    """Photon-sharded bench over every visible device (the reference's
    MPI analogue): aggregate and per-device photons/s."""
    from rsmcrt_tpu.parallel.mesh import make_mesh, simulate_sharded_chunked

    scene, grid, src = bench_case()
    mesh = make_mesh()
    n_dev = info["device_count"]
    cfg, kw = bench_config(fluence=True)
    cfg = dataclasses.replace(cfg, nphotons=cfg.nphotons * n_dev)
    chunk = kw["chunk_steps"]

    # warmup compiles the chunk program (same shapes, traced budget)
    simulate_sharded_chunked(scene, src, grid, jax.random.key(0), cfg,
                             mesh=mesh, chunk_steps=chunk,
                             nphotons=max(cfg.n_lanes // 8, 1) * n_dev)
    t0 = time.perf_counter()
    tallies, _, launched, _ = simulate_sharded_chunked(
        scene, src, grid, jax.random.key(1), cfg, mesh=mesh,
        chunk_steps=chunk)
    jax.block_until_ready(tallies)
    dt = time.perf_counter() - t0
    value = int(launched) / dt
    print(json.dumps({
        "metric": f"photons_per_second_sphere_scene_{n_dev}dev_sharded",
        "value": value, "unit": "photons/s",
        "per_device": value / n_dev, **info,
    }))


def main(info, with_detector: bool = False):
    from rsmcrt_tpu.detectors.detectors import totals

    value, _, bank_out = run_cell(fluence=True, with_detector=with_detector)
    out = {
        "metric": ("photons_per_second_sphere_scene_1dev"
                   + ("_circle_detector" if with_detector else "")),
        "value": value, "unit": "photons/s", **info,
    }
    if with_detector:
        out["detector_total"] = float(totals(bank_out)[0])
    else:
        # the fluenceless (detector-workload) rate rides along: half the
        # reference's real workloads run with the path-length estimator
        # off, where no voxel deposits exist
        out["fluenceless_photons_per_second"] = run_cell(
            fluence=False, with_detector=True)[0]
    print(json.dumps(out))


def main_fluenceless(info):
    value = run_cell(fluence=False, with_detector=True)[0]
    print(json.dumps({
        "metric": "photons_per_second_sphere_fluenceless_detector_1dev",
        "value": value, "unit": "photons/s", **info,
    }))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--sharded", action="store_true",
                    help="photon-shard over all visible devices")
    ap.add_argument("--detector", action="store_true",
                    help="bench with a circle detector in the scene")
    ap.add_argument("--fluenceless", action="store_true",
                    help="detector-workload bench, path-length estimator "
                         "off (no fluence deposits)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (explicit; never a fallback)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    info = require_gpu(allow_cpu=args.cpu)
    if args.sharded:
        main_sharded(info)
    elif args.fluenceless:
        main_fluenceless(info)
    else:
        main(info, with_detector=args.detector)
