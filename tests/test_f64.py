"""float64 transport end-to-end (VERDICT r2 missing #3 / next #9).

The reference transports in f64 with eps = 1e-8
(reference: src/constants.f90:18, src/inttau2.f90:56); this framework
defaults to f32 + eps = 1e-5.  The f64 mode must run the physics
gates end-to-end (including Fresnel chaining at the reference eps) and
agree with the f32 engine -- bounding the f32 error.  Runs in a
subprocess because ``jax_enable_x64`` is process-global."""

import json
import subprocess
import sys
from pathlib import Path

import pytest


@pytest.mark.slow
def test_f64_transport_end_to_end(tmp_path):
    worker = Path(__file__).parent / "f64_worker.py"
    out = tmp_path / "f64.json"
    env = {
        "PYTHONPATH": str(Path(__file__).resolve().parents[1]),
        "PATH": "/usr/bin:/bin:/usr/local/bin",
        "HOME": "/root",
    }
    p = subprocess.run(
        [sys.executable, str(worker), str(out)], env=env,
        capture_output=True, timeout=900,
    )
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    r = json.loads(out.read_text())
    assert r["launched"] == 3000
    # nscatt gate: tau^2/2 + tau = 57.5 (ref thr 0.5 at 1e5; SE ~1 at 3e3)
    assert abs(r["nscatt_per_photon"] - 57.5) < 3.5, r
    # f32 engine agreement on the refractive scene (same budget, CPU):
    # bounds the f32-at-eps-1e-5 deviation the design accepts
    import jax
    import jax.numpy as jnp

    from rsmcrt_tpu.grid import cart_grid
    from rsmcrt_tpu.optics.properties import mono
    from rsmcrt_tpu.sdfs import scene as S
    from rsmcrt_tpu.sources.sources import build_source
    from rsmcrt_tpu.transport.engine import TransportConfig, simulate

    scene = S.build_scene([
        S.sphere(1.0, mono(10.0, 0.1, 0.9, 1.38), 1),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2),
    ])
    grid = cart_grid(32, 32, 32, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.0])
    cfg = TransportConfig(nphotons=3000, n_lanes=256, chain_scatter=True)
    t, _, n, _ = simulate(scene, src, grid, jax.random.key(9), cfg,
                          chunk_steps=400)
    j32 = float(jnp.sum(t.jmean)) / int(n)
    assert abs(j32 - r["fresnel_jsum_per_photon"]) / j32 < 0.05, (
        j32, r["fresnel_jsum_per_photon"])
