"""Weak-scaling protocol for the photon-sharded mesh driver
(VERDICT r4 next #6).

The old "mesh efficiency" number compared 8 virtual devices against one
device at equal TOTAL lanes on a 2-core box -- confounded by CPU
oversubscription.  This protocol holds the PER-DEVICE work fixed (lanes,
photon budget per device) and sweeps the mesh size n in {1, 2, 4, 8},
measuring steady-state per-megastep wall time T(n).  On an
oversubscribed host, per-device compute serialises onto the cores, so

    T(n) = a + b * n

with b = per-device compute (including any serialisation) and a = the
mesh-size-independent dispatch/driver overhead.  The sharded-driver
overhead fraction a / T(n) is the quantity the virtual mesh CAN measure;
collective cost cannot be observed on a virtual mesh and is excluded
by construction (the chunk loop contains no collectives -- tallies
reduce once at the end).

Usage: python tools/profile_mesh_scaling.py  (runs on CPU; forces the
virtual 8-device mesh itself)
"""

import os
import sys
import time
from pathlib import Path

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from rsmcrt_tpu.grid import cart_grid  # noqa: E402
from rsmcrt_tpu.optics.properties import mono  # noqa: E402
from rsmcrt_tpu.parallel.mesh import simulate_sharded_chunked  # noqa: E402
from rsmcrt_tpu.sdfs import scene as S  # noqa: E402
from rsmcrt_tpu.sources.sources import build_source  # noqa: E402
from rsmcrt_tpu.transport.engine import TransportConfig  # noqa: E402


def build():
    scene = S.build_scene([
        S.sphere(1.0, mono(10.0, 0.0, 0.0, 1.0), 1),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2),
    ])
    grid = cart_grid(32, 32, 32, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.0])
    return scene, grid, src


def time_mesh(n_dev, n_steps=48, lanes_per_dev=256, repeats=3):
    scene, grid, src = build()
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("dp",))
    cfg = TransportConfig(nphotons=1 << 30, n_lanes=lanes_per_dev,
                          max_steps=n_steps)

    def run():
        t, _, _, s = simulate_sharded_chunked(
            scene, src, grid, jax.random.key(3), cfg, mesh=mesh,
            chunk_steps=n_steps)
        jax.block_until_ready(t.jmean)
        assert int(s) == n_steps
    run()  # compile
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best / n_steps  # per-megastep seconds


def main():
    ns = [1, 2, 4, 8]
    ts = []
    for n in ns:
        t = time_mesh(n)
        ts.append(t)
        print(f"n_dev={n}: {t * 1e3:.2f} ms/megastep "
              f"({t * 1e3 / n:.2f} ms/device-step)", flush=True)
    # least-squares fit T(n) = a + b n
    A = np.stack([np.ones(len(ns)), np.asarray(ns, float)], axis=-1)
    (a, b), *_ = np.linalg.lstsq(A, np.asarray(ts), rcond=None)
    print(f"\nfit: T(n) = {a * 1e3:.2f} ms + {b * 1e3:.2f} ms * n_dev")
    for n, t in zip(ns, ts):
        ov = max(a, 0.0) / t
        print(f"n_dev={n}: driver overhead fraction {ov:.1%} "
              f"(efficiency bound {1 - ov:.1%})")


if __name__ == "__main__":
    main()
