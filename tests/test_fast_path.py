"""Round-4 fast-path-as-default gates (VERDICT r3 next #2 + ADVICE r3).

The chained walk is now the PRODUCT default: kernels.run_MCRT and
bench.py build their TransportConfig from the same
``kernels.fast_path_defaults()``, in-chain respawn works with emission
recording, and the ADVICE r3 s_prev-overwrite fix is regression-gated.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rsmcrt_tpu.grid import cart_grid
from rsmcrt_tpu.optics.properties import mono
from rsmcrt_tpu.sdfs import scene as S
from rsmcrt_tpu.sources.sources import build_source
from rsmcrt_tpu.transport.engine import TransportConfig, simulate


def _sphere_case():
    scene = S.build_scene([
        S.sphere(1.0, mono(10.0, 0.1, 0.9, 1.38), 1),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2),
    ])
    grid = cart_grid(50, 50, 50, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.0])
    return scene, grid, src


def test_chain_respawn_records_emission():
    """Round 4: record_emission no longer disables in-chain respawn --
    consumed candidates write their launch voxel into the emission tally
    (one scatter per megastep), so the emission count stays exact."""
    scene, grid, src = _sphere_case()
    steps = {}
    for chain in (False, True):
        cfg = TransportConfig(nphotons=4000, n_lanes=512, dda_substeps=8,
                              record_emission=True, chain_scatter=chain)
        t, _, n, s = simulate(scene, src, grid, jax.random.key(11), cfg,
                              chunk_steps=256)
        assert int(n) == 4000
        # every launched photon of this always-inside source is recorded
        assert float(jnp.sum(t.emission)) == 4000.0
        steps[chain] = int(s)
    # chaining (incl. in-chain respawn) engaged despite emission recording
    assert steps[True] < steps[False]


def test_chain_respawn_grid_exit_media_beyond_grid():
    """ADVICE r3 (medium) regression: medium extends past the fluence
    grid, so lanes die at the grid wall MID-segment (exit_now with
    ends=False) and respawn in-chain.  The respawned photon's first
    deposit interval must not inherit the dead photon's next-wall
    distance (the s_prev overwrite corrupted the near-source fluence)."""
    scene = S.build_scene([
        S.box([4.0, 4.0, 4.0], mono(3.0, 0.3, 0.5, 1.0), 1),
    ])
    grid = cart_grid(40, 40, 40, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.0])
    out = {}
    for chain in (False, True):
        cfg = TransportConfig(nphotons=4000, n_lanes=512, dda_substeps=8,
                              chain_scatter=chain)
        t, _, n, _ = simulate(scene, src, grid, jax.random.key(7), cfg,
                              chunk_steps=256)
        assert int(n) == 4000
        out[chain] = np.asarray(t.jmean).reshape(40, 40, 40)
    a, b = out[False], out[True]
    ta, tb = a.sum(), b.sum()
    assert ta > 0 and tb > 0
    assert abs(ta - tb) / ta < 0.05, (ta, tb)
    # the corruption concentrates at the source voxel neighbourhood
    ca = a[18:22, 18:22, 18:22].sum()
    cb = b[18:22, 18:22, 18:22].sum()
    assert abs(ca - cb) / ca < 0.05, (ca, cb)
    pa, pb = a.sum(axis=(0, 1)), b.sum(axis=(0, 1))
    assert np.abs(pa - pb).sum() / pa.sum() < 0.1


class _Captured(Exception):
    pass


def test_bench_and_product_share_fast_path_config(monkeypatch):
    """kernels.run_MCRT and bench.py must build the same transport config
    and simulate arguments from the device row, so the benchmarked
    program IS the product program (VERDICT r3 #2 acceptance)."""
    import bench
    from rsmcrt_tpu import kernels

    fp = kernels.fast_path_defaults()
    assert fp["chain_scatter"] is True
    assert fp["dda_substeps"] >= 8

    seen = {}

    def capture(scene, source, grid, key, cfg, **kw):
        seen["cfg"] = cfg
        seen["kw"] = {k: kw[k] for k in ("chunk_steps", "min_lanes")}
        raise _Captured

    monkeypatch.setattr(kernels, "simulate", capture)
    toml = pathlib.Path(__file__).parents[1] / "res" / "sphere.toml"
    parsed, scene = kernels.setup(toml)
    n = 4000
    with pytest.raises(_Captured):
        kernels.run_MCRT(parsed, scene, nphotons=n)

    cfg, kw = bench.bench_config(fluence=True, nphotons=n)
    assert cfg == seen["cfg"]
    assert kw == seen["kw"]
    # the fluenceless cell takes the same fast-path knobs as a
    # fluenceless product run
    cfg_nf, _ = bench.bench_config(fluence=False, nphotons=n)
    fp_nf = kernels.fast_path_defaults(fluence=False)
    assert {k: getattr(cfg_nf, k) for k in fp_nf} == fp_nf


def test_run_MCRT_engages_chaining():
    """default_MCRT's transport must actually chain on a chainable scene:
    ~1 segment analysis per photon (the plain walk needs one per flight
    segment, ~6+/photon on the scat_test scene)."""
    from rsmcrt_tpu.kernels import run_MCRT, setup

    toml = pathlib.Path(__file__).parents[1] / "res" / "scat_test.toml"
    parsed, scene = setup(toml)
    res = run_MCRT(parsed, scene, nphotons=500, n_lanes=256)
    assert res.launched == 500
    perf = np.asarray(res.tallies.perf)
    n_analyses = int(perf[2])
    assert n_analyses < 2.5 * res.launched, n_analyses
