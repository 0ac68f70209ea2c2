"""Fluenceless (detector-workload) throughput sweep -- VERDICT r4 next #1.

The path-length estimator OFF regime (reference without -Dpathlength,
inttau2.f90:446-462): no voxel deposits, so the scatter wall does not
exist and each chained round consumes a WHOLE segment event.  This is
the regime of escape functions, detector/inverse runs and validations.

Sweeps K (chain rounds / megastep) x B (lanes) on the bench sphere with
the bench circle detector, reporting photons/s.

Usage: python tools/profile_fluenceless.py [-n 2000000]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

from bench import bench_bank, bench_case  # noqa: E402
from rsmcrt_tpu.transport.engine import (  # noqa: E402
    TransportConfig,
    simulate,
    warmup,
)


def run_one(n, lanes, K, chunk, detector=True, min_lanes=64, respawns=1):
    scene, grid, src = bench_case()
    bank = bench_bank() if detector else None
    cfg = TransportConfig(
        nphotons=n, n_lanes=lanes, record_fluence=False,
        record_emission=False, chain_scatter=True, dda_substeps=K,
        chain_respawns=respawns,
    )
    warmup(scene, src, grid, jax.random.key(0), cfg, bank=bank,
           chunk_steps=chunk, min_lanes=min_lanes)
    t0 = time.perf_counter()
    tallies, bank_out, launched, steps = simulate(
        scene, src, grid, jax.random.key(1), cfg, bank=bank,
        nphotons=n, min_lanes=min_lanes, chunk_steps=chunk,
    )
    jax.block_until_ready(tallies)
    dt = time.perf_counter() - t0
    return int(launched) / dt, int(steps)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=2_000_000)
    ap.add_argument("--grid", action="store_true",
                    help="full K x B x chunk sweep (default: quick)")
    ap.add_argument("--respawns", type=str, default="1",
                    help="comma list of chain_respawns values to sweep")
    args = ap.parse_args()

    respawns = [int(x) for x in args.respawns.split(",")]
    cases = ([(32768, K, c) for K in (16, 32, 64, 128) for c in (24, 48)]
             if args.grid else
             [(32768, 32, 48), (32768, 64, 48), (32768, 128, 24)]
             if respawns == [1] else
             # respawn sweep: only one K (each (C, K) is a fresh ladder
             # compile)
             [(32768, 64, 48)])
    for C in respawns:
        for lanes, K, chunk in cases:
            rate, steps = run_one(args.n, lanes, K, chunk, respawns=C)
            print(f"C={C} B={lanes} K={K} chunk={chunk}: "
                  f"{rate/1e3:.1f}k ph/s ({steps} megasteps)", flush=True)


if __name__ == "__main__":
    main()
