"""Main-phase photon throughput across scene families (VERDICT r3 #3).

Measures the chained fast path on the sphere bench scene vs the
previously-unchainable scenes: the egg scene (revolution-of-egg shells,
analytic since round 4) and the omg scene (smooth-union CSG model,
chained via the in-chain bounded march).  Acceptance: egg/omg within
~2-3x of the sphere rate.

Run from the repository root:
  python tools/profile_scenes.py
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from bench import bench_case  # noqa: E402
from rsmcrt_tpu.grid import cart_grid  # noqa: E402
from rsmcrt_tpu.scenes import setup_simulation  # noqa: E402
from rsmcrt_tpu.sdfs import raycast, scene as S  # noqa: E402
from rsmcrt_tpu.sources.sources import build_source  # noqa: E402
from rsmcrt_tpu.transport.engine import (  # noqa: E402
    TransportConfig, init_carry, _run_steps,
)


def egg_case():
    params = {
        "mus": [1.0, 10.0, 5.0], "mua": [0.1, 0.2, 0.3],
        "hgg": [0.0, 0.9, 0.5], "n": [1.5, 1.35, 1.4],
        "boundinglength": [2.0, 2.0, 2.0],
        "BottomSphereRadius": 0.9,
        "TopSphereRadius": 0.9 * np.sqrt(2.0 - np.sqrt(2.0)),
        "SphereSep": 0.9 * np.sqrt(2.0 - np.sqrt(2.0)),
        "YolkRadius": 0.45,
    }
    scene = S.build_scene(setup_simulation("egg", params))
    grid = cart_grid(200, 200, 200, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.2, 0.0])
    return scene, grid, src


def omg_case():
    scene = S.build_scene(setup_simulation("omg", {}))
    grid = cart_grid(200, 200, 200, 1.0, 1.0, 1.0)
    # uniform xy sheet just inside the -z wall firing up through the
    # lettering (reference omg.toml uses a uniform source)
    src = build_source("uniform",
                       point1=[-1.0, -1.0, -1.95],
                       point2=[2.0, 0.0, 0.0],
                       point3=[0.0, 2.0, 0.0],
                       direction=[0.0, 0.0, 1.0])
    return scene, grid, src


def main():
    key = jax.random.key(7)
    chunk = 48
    n_chunks = 6
    budget = 100_000_000  # never exhausted: continuous respawn
    B, K = 32768, 64

    cases = [("sphere", bench_case()), ("egg", egg_case()),
             ("omg", omg_case())]
    base = None
    for name, (scene, grid, src) in cases:
        mask = raycast.analytic_column_mask(scene)
        cfg = TransportConfig(nphotons=budget, n_lanes=B,
                              dda_substeps=K, chain_scatter=True)
        carry = init_carry(grid, cfg)
        carry = _run_steps(scene, src, grid, key, carry, cfg, chunk)
        int(carry.launched)  # host read = sync
        t0 = time.perf_counter()
        l0 = int(carry.launched)
        for _ in range(n_chunks):
            carry = _run_steps(scene, src, grid, key, carry, cfg, chunk)
        l1 = int(carry.launched)  # host read = sync
        dt = time.perf_counter() - t0
        rate = (l1 - l0) / dt
        if base is None:
            base = rate
        print(f"{name:8s} analytic={sum(mask)}/{len(mask)} "
              f"{rate/1e3:8.1f}k ph/s  ({base/max(rate,1):4.1f}x slower "
              f"than sphere)", flush=True)


if __name__ == "__main__":
    main()
