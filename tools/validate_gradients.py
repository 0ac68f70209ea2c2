"""High-statistics gradient validation vs finite differences.

BASELINE.md asks gradients (mus, mua, g, n, SDF params) to match finite
differences.  The pMC scores (mus, mua, g) are likelihood-ratio
derivatives -- exact in expectation; n and shape derivatives use
common-random-number central differences.  This tool measures the
agreement at photon counts a CPU test cannot afford: the FD reference is
averaged over several independent seeds so its own Monte Carlo error is
driven below the comparison tolerance.

Usage:  python tools/validate_gradients.py [-n 1000000] [-s 8]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def score_validation(nphotons: int, lanes: int, seeds: int):
    """High-stat validation of the round-4 n / shape likelihood scores in
    their exact domains (VERDICT r3 next #4):

    - n: Fresnel-choice score vs the CLOSED-FORM slab transmission
      derivative d/dn (1-R)/(1+R) -- no FD noise at all;
    - radius: boundary extinction score vs Richardson-extrapolated CRN
      central differences on a matched-index mua-contrast sphere.
    """
    import jax
    import jax.numpy as jnp

    from rsmcrt_tpu.detectors.detectors import (CircleDetectors,
                                                DetectorBank, totals)
    from rsmcrt_tpu.grid import cart_grid
    from rsmcrt_tpu.optics.properties import mono
    from rsmcrt_tpu.sdfs import scene as S
    from rsmcrt_tpu.sources.sources import build_source
    from rsmcrt_tpu.transport.engine import (TransportConfig, simulate,
                                             warmup)
    from rsmcrt_tpu.transport.fresnel import fresnel_coeff

    def bank(z, radius):
        circ = CircleDetectors(
            pos=jnp.asarray([[0.0, 0.0, z]]),
            dir=jnp.asarray([[0.0, 0.0, 1.0]]),
            radius=jnp.asarray([radius]),
            bin_wid=jnp.asarray([radius / 4]),
            data=jnp.zeros((1, 5), jnp.float32), nbins=4,
        )
        return DetectorBank(
            circle=circ, annulus=None, fibre=None, camera=None,
            target_values=jnp.asarray([-1.0]), order=(("circle", 0),),
            ids=("t",), layers=(2,),
        )

    # --- n: vacuum slab at 40 deg vs closed form ------------------------
    n_slab, theta = 1.5, np.deg2rad(2.0)
    d = np.array([np.sin(theta), 0.0, np.cos(theta)], np.float32)

    def T_of_n(nv):
        R = fresnel_coeff(jnp.asarray(d)[None],
                          jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32),
                          jnp.asarray([1.0]), jnp.asarray([nv]))[0]
        return (1.0 - R) / (1.0 + R)

    dT_exact = float(jax.grad(lambda v: T_of_n(v))(jnp.asarray(n_slab)))
    scene = S.build_scene([
        S.box([5.8, 5.8, 0.2], mono(0.0, 0.0, 0.0, n_slab), 1),
        S.box([6.0, 6.0, 4.0], mono(0.0, 0.0, 0.0, 1.0), 2),
    ])
    grid = cart_grid(16, 16, 16, 3.0, 3.0, 2.0)
    src = build_source("pencil", position=[0.0, 0.0, -1.2],
                       direction=d.tolist())
    cfg = TransportConfig(nphotons=nphotons, n_lanes=lanes,
                          inverse_prim=1, record_fluence=False,
                          chain_scatter=True)
    vals = []
    for s in range(seeds):
        t, b, nl, _ = simulate(scene, src, grid, jax.random.key(50 + s),
                               cfg, bank=bank(1.0, 2.8), chunk_steps=96)
        vals.append(float(np.asarray(t.pmc_stats)[0, 4]) / int(nl))
    v = np.asarray(vals)
    est, sem = v.mean(), v.std() / np.sqrt(len(v))
    print(f"{'n':8s} {est:12.5f} {sem:10.5f} {dT_exact:12.5f} "
          f"{'(exact)':>10s} {(est - dT_exact) / abs(dT_exact):+9.4f}",
          flush=True)

    # --- radius: matched-index sphere vs Richardson CRN FD --------------
    mus, g, mua_in, mua_out, r0 = 5.0, 0.3, 1.0, 0.05, 0.7

    def build(r):
        return S.build_scene([
            S.sphere(r, mono(mus, mua_in, g, 1.0), 1),
            S.box([2.0, 2.0, 2.0], mono(mus, mua_out, g, 1.0), 2),
        ])

    grid2 = cart_grid(16, 16, 16, 1.0, 1.0, 1.0)
    src2 = build_source("point", position=[0.0, 0.0, 0.0])

    def run_r(r, seed, inverse):
        cfg = TransportConfig(nphotons=nphotons, n_lanes=lanes,
                              inverse_prim=inverse,
                              record_fluence=False, chain_scatter=True)
        t, b, nl, _ = simulate(build(r), src2, grid2,
                               jax.random.key(seed), cfg,
                               bank=bank(0.9, 1.0), chunk_steps=96)
        st = np.asarray(t.pmc_stats)[0, 5] if inverse else 0.0
        return float(st), float(totals(b)[0]), int(nl)

    vals = []
    for s in range(seeds):
        st, _, nl = run_r(r0, 70 + s, 1)
        vals.append(st / nl)
    v = np.asarray(vals)
    est, sem = v.mean(), v.std() / np.sqrt(len(v))

    def fd_at(h, seed_base):
        out = []
        for s in range(seeds):
            _, hi, n_hi = run_r(r0 + h, seed_base + s, 0)
            _, lo, n_lo = run_r(r0 - h, seed_base + s, 0)
            out.append((hi / n_hi - lo / n_lo) / (2 * h))
        o = np.asarray(out)
        return o.mean(), o.std() / np.sqrt(len(o))

    f1, s1 = fd_at(0.04, 900)
    f2, s2 = fd_at(0.02, 900)
    fdm = (4.0 * f2 - f1) / 3.0
    fsem = np.sqrt(16.0 * s2 ** 2 + s1 ** 2) / 3.0
    print(f"{'radius':8s} {est:12.5f} {sem:10.5f} {fdm:12.5f} "
          f"{fsem:10.5f} {(est - fdm) / abs(fdm):+9.4f}", flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("-n", type=int, default=1_000_000)
    p.add_argument("-s", type=int, default=8, help="FD seeds to average")
    p.add_argument("--lanes", type=int, default=32768)
    p.add_argument("--config", default="res/inverse_test.toml")
    p.add_argument("--params", default=None,
                   help="csv subset of mua,mus,g (skips n/radius section)")
    p.add_argument("--fd-seeds", type=int, default=None,
                   help="independent seed count for the FD side")
    p.add_argument("--richardson", action="store_true",
                   help="Richardson-extrapolate the FD (two step sizes)")
    p.add_argument("--scores", action="store_true",
                   help="validate the round-4 n/shape likelihood scores "
                        "in their exact domains instead")
    args = p.parse_args()
    if args.scores:
        print(f"{'param':8s} {'estimator':>12s} {'est sem':>10s} "
              f"{'reference':>12s} {'ref sem':>10s} {'rel diff':>9s}")
        score_validation(args.n, args.lanes, args.s)
        return

    from rsmcrt_tpu.inverse import (
        _forward, _prim_group_slot, _set_prim_optics, _set_prim_shape,
        detector_gradients,
    )

    res = detector_gradients(args.config, nphotons=args.n,
                             n_lanes=args.lanes, seed=3, chain=True)
    parsed, scene, cfg, pi = (res["parsed"], res["scene"], res["cfg"],
                              res["prim_index"])
    i = pi + 1
    t = scene.tables
    base = dict(mus=float(t.mus[i]), mua=float(t.mua[i]),
                g=float(t.hgg[i]), n=float(t.n[i]))
    g_slot, m_slot = _prim_group_slot(scene, pi)
    base["radius"] = float(
        np.asarray(scene.group_params[g_slot]["radius"])[m_slot]
    )
    mus0 = base["mus"]

    def run(th, seed):
        sc = _set_prim_optics(scene, pi, th["mus"], th["mua"], th["g"],
                              th["n"])
        sc = _set_prim_shape(sc, pi, "radius", th["radius"])
        tot, stats, n = _forward(parsed, sc, cfg, seed, inverse_prim=i)
        return tot.astype(np.float64), stats, n

    # pMC estimator averaged over independent seeds: at 1M photons a
    # single run's own MC error dominates the FD comparison; averaging
    # S seeds drives it below the 1e-3 acceptance (BASELINE.md)
    seeds = [101 + 7 * k for k in range(args.s)]
    est_rows = {"mua": [], "mus": [], "g": []}
    N = 0
    for s in seeds:
        _, stats, n = run(base, 7777 + s)
        sw, swc, swl, swh = (stats[:, j].astype(np.float64)
                             for j in range(4))
        est_rows["mua"].append(-swl / n)
        est_rows["mus"].append((swc / max(mus0, 1e-9) - swl) / n)
        est_rows["g"].append(swh / n)
        N += n

    def fd(param, h, seeds):
        vals = []
        for s in seeds:
            hi, _, n_hi = run({**base, param: base[param] + h}, s)
            lo, _, n_lo = run({**base, param: base[param] - h}, s)
            vals.append((hi / n_hi - lo / n_lo) / (2 * h))
        v = np.stack(vals)
        return v.mean(0), v.std(0) / np.sqrt(len(seeds))

    print(f"photons/run: {args.n}, seeds: {len(seeds)} "
          f"(pMC total {N} photons)")
    print(f"{'param':8s} {'estimator':>12s} {'est sem':>10s} {'FD':>12s} "
          f"{'FD sem':>10s} {'rel diff':>9s}")
    fd_seeds = [301 + 11 * k for k in range(args.fd_seeds or args.s)]
    want = set((args.params or "mua,mus,g").split(","))
    for param, h in (("mua", 0.05), ("mus", 0.25), ("g", 0.025)):
        if param not in want:
            continue
        v = np.stack(est_rows[param])
        est = v.mean(0)[0]
        est_sem = (v.std(0) / np.sqrt(len(seeds)))[0]
        if args.richardson:
            # Richardson extrapolation kills the O(h^2) FD bias:
            # (4 FD(h/2) - FD(h)) / 3
            f1, s1 = fd(param, h, fd_seeds)
            f2, s2 = fd(param, h / 2, fd_seeds)
            fdm = (4.0 * f2 - f1) / 3.0
            sem = np.sqrt((16.0 * s2**2 + s1**2)) / 3.0
        else:
            fdm, sem = fd(param, h, fd_seeds)
        rel = (est - fdm[0]) / abs(fdm[0])
        print(f"{param:8s} {est:12.5f} {est_sem:10.5f} {fdm[0]:12.5f} "
              f"{sem[0]:10.5f} {rel:+9.4f}", flush=True)
    if args.params:
        return

    # n and radius: the estimator IS a CRN difference; validate h- and
    # seed-independence (two h's, independent seed sets)
    for param, h1, h2 in (("n", 0.02, 0.04), ("radius", 0.02, 0.04)):
        d1, s1 = fd(param, h1, seeds)
        d2, s2 = fd(param, h2, [s + 1000 for s in seeds])
        rel = (d1[0] - d2[0]) / abs(d2[0])
        print(f"{param:8s} {d1[0]:12.5f} {d2[0]:12.5f} "
              f"{max(s1[0], s2[0]):10.5f} {rel:+9.4f}")


if __name__ == "__main__":
    main()
