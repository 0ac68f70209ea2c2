"""Wavefront efficiency regression gates.

The engine's throughput hinges on structural invariants that ordinary
physics tests cannot see: a photon must take a bounded number of megasteps
(sphere-trace creep once cost 100+ steps/photon creeping at 2*eps along
grazing boundaries -- fixed by the analytic raycast, sdfs/raycast.py), and
deposit-slot utilisation must stay high.  These bounds are measured with
``Tallies.perf`` on the bench sphere scene.
"""

import jax
import numpy as np

from rsmcrt_tpu.grid import cart_grid
from rsmcrt_tpu.optics.properties import mono
from rsmcrt_tpu.sdfs import scene as S
from rsmcrt_tpu.sources.sources import build_source
from rsmcrt_tpu.transport.engine import TransportConfig, simulate


def test_bench_scene_step_budget():
    scene = S.build_scene([
        S.sphere(1.0, mono(10.0, 0.1, 0.9, 1.38), 1),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2),
    ])
    grid = cart_grid(200, 200, 200, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.0])
    K = 16
    cfg = TransportConfig(nphotons=2000, n_lanes=1024, dda_substeps=K)
    tallies, _, launched, _ = simulate(scene, src, grid,
                                       jax.random.key(5), cfg,
                                       chunk_steps=64, min_lanes=256)
    p = np.asarray(tallies.perf) / int(launched)
    deposits, alive_steps, analyses, interactions = p
    # measured on this scene: ~307 deposits, ~32 alive-steps, 22 analyses,
    # 17 interactions per photon; generous margins
    assert alive_steps < 50, f"steps/photon regressed: {alive_steps:.1f}"
    assert analyses < 30, f"analyses/photon regressed: {analyses:.1f}"
    assert deposits / (alive_steps * K) > 0.45, (
        f"deposit slot utilisation regressed: "
        f"{deposits / (alive_steps * K):.2f}"
    )
    # sanity: the physics did happen
    assert 250 < deposits < 400, deposits
    assert 12 < interactions < 25, interactions
