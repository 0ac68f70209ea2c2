"""Measure main-phase (full-width wavefront) photon throughput with and
without in-line scatter chaining, across DDA substep budgets K.

The tail phase is identical either way, so the main-phase rate isolates
what chaining changes: megasteps/photon and deposit-slot utilisation.

Run from the repository root:
  python tools/profile_chain.py [--grid B:K:chain,...]
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bench import bench_case  # noqa: E402
from rsmcrt_tpu.transport.engine import (  # noqa: E402
    TransportConfig, init_carry, _run_steps,
)


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=str, default=None,
                    help="comma list of B:K:chain triplets")
    args = ap.parse_args()

    scene, grid, src = bench_case()
    key = jax.random.key(7)
    chunk = 96
    n_chunks = 10
    budget = 100_000_000  # never exhausted: continuous respawn

    if args.grid:
        combos = []
        for t in args.grid.split(","):
            B_, K_, c_ = (int(x) for x in t.split(":"))
            combos.append((bool(c_), K_, B_))
    else:
        combos = [(False, 16, 32768), (True, 16, 32768),
                  (True, 24, 32768), (True, 32, 32768),
                  (True, 48, 32768), (True, 64, 32768)]

    for chain, K, B in combos:
        cfg = TransportConfig(nphotons=budget, n_lanes=B,
                              dda_substeps=K, chain_scatter=chain)
        carry = init_carry(grid, cfg)
        # compile + warm
        carry = _run_steps(scene, src, grid, key, carry, cfg, chunk)
        int(carry.launched)
        t0 = time.perf_counter()
        l0 = int(carry.launched)
        perf0 = [int(v) for v in carry.tallies.perf]
        for _ in range(n_chunks):
            carry = _run_steps(scene, src, grid, key, carry, cfg, chunk)
            launched = int(carry.launched)  # host read each chunk
        dt = time.perf_counter() - t0
        steps = n_chunks * chunk
        # deltas over the timed window: the cumulative int32 counters
        # overflow at ~2e9 deposits (long profiles)
        perf = [int(v) - p0 for v, p0 in
                zip(carry.tallies.perf, perf0)]
        util = perf[0] / max(perf[1], 1) / K  # deposits / (alive*K)
        print(f"chain={int(chain)} K={K:2d}: "
              f"{(launched - l0) / dt / 1e3:7.1f}k ph/s main-phase, "
              f"{dt / steps * 1e3:6.2f} ms/step, slot-util {util:.2f}",
              flush=True)


if __name__ == "__main__":
    main()
