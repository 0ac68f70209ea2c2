"""Ablation timing of the transport megastep on the bench sphere scene.

Times N fixed megasteps (fori_loop, no early exit) for the full step and
for isolated pieces, to locate where per-step time goes on the device.
"""

from __future__ import annotations

import argparse
import os
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))
from _timing import timed  # noqa: E402  (forces a host read per timing)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("-B", type=int, default=32768)
    p.add_argument("-K", type=int, default=8)
    p.add_argument("-n", type=int, default=50, help="megasteps per timing")
    args = p.parse_args()

    from bench import bench_case
    from rsmcrt_tpu.grid import get_voxel, voxel_flat_index
    from rsmcrt_tpu.sdfs.scene import calc_normals, eval_scene
    from rsmcrt_tpu.sources.sources import sample as sample_source
    from rsmcrt_tpu.transport.engine import (
        TransportConfig, init_carry, transport_step,
    )

    B, K, N = args.B, args.K, args.n
    scene, grid, src = bench_case()
    cfg = TransportConfig(nphotons=1 << 30, n_lanes=B, dda_substeps=K)
    key = jax.random.key(0)

    def steps_fn(cfg):
        @jax.jit
        def run(carry):
            def body(_, c):
                return transport_step(c, scene, src, grid, key, cfg,
                                      jnp.asarray(1 << 30, jnp.int32))
            return jax.lax.fori_loop(0, N, body, carry)
        return run

    carry = init_carry(grid, cfg)
    full = timed(steps_fn(cfg), carry) / N
    print(f"full step              {full*1e3:8.3f} ms")

    cfg_nf = TransportConfig(nphotons=1 << 30, n_lanes=B, dda_substeps=K,
                             record_fluence=False)
    carry2 = init_carry(grid, cfg_nf)
    nofl = timed(steps_fn(cfg_nf), carry2) / N
    print(f"no-fluence step        {nofl*1e3:8.3f} ms  (DDA+scatter = "
          f"{(full-nofl)*1e3:.3f})")

    # isolated pieces ----------------------------------------------------
    pos = jax.random.uniform(key, (B, 3), jnp.float32, -0.9, 0.9)
    dirs = jax.random.normal(key, (B, 3), jnp.float32)
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)

    @jax.jit
    def f_eval(p):
        def body(_, acc):
            return acc + jnp.sum(eval_scene(scene, p), -1)
        return jax.lax.fori_loop(0, N, body, jnp.zeros(B))
    print(f"eval_scene             {timed(f_eval, pos)/N*1e3:8.3f} ms")

    @jax.jit
    def f_norm(p):
        def body(_, acc):
            return acc + jnp.sum(calc_normals(scene, p, 1e-4), (-1, -2))
        return jax.lax.fori_loop(0, N, body, jnp.zeros(B))
    print(f"calc_normals           {timed(f_norm, pos)/N*1e3:8.3f} ms")

    @jax.jit
    def f_src(u):
        def body(i, acc):
            ps, ds, ph, wl = sample_source(src, grid, u)
            return acc + jnp.sum(ps, -1)
        return jax.lax.fori_loop(0, N, body, jnp.zeros(B))
    u8 = jax.random.uniform(key, (B, 8), jnp.float32, 1e-12, 1.0)
    print(f"sample_source          {timed(f_src, u8)/N*1e3:8.3f} ms")

    @jax.jit
    def f_rng(c):
        def body(i, acc):
            sk = jax.random.fold_in(key, i)
            return acc + jax.random.uniform(sk, (B, 16), jnp.float32,
                                            1e-12, 1.0)
        return jax.lax.fori_loop(0, N, body, c)
    print(f"rng 16 uniforms        {timed(f_rng, jnp.zeros((B,16)))/N*1e3:8.3f} ms")

    cand0 = jax.random.uniform(key, (B, 3 * K), jnp.float32)

    @jax.jit
    def f_sort(c):
        def body(_, acc):
            return acc + jnp.sort(c + acc[:, :1] * 0, axis=-1)
        return jax.lax.fori_loop(0, N, body, c)
    print(f"sort [B,3K]            {timed(f_sort, cand0)/N*1e3:8.3f} ms")

    flat = jax.random.randint(key, (B * K,), 0, 200**3)
    vals = jax.random.uniform(key, (B * K,), jnp.float32)
    gbuf = jnp.zeros((200**3,), jnp.float32)

    @jax.jit
    def f_scat(g, f, v):
        def body(_, gg):
            return gg.at[f].add(v)
        return jax.lax.fori_loop(0, N, body, g)
    print(f"scatter-add B*K        {timed(f_scat, gbuf, flat, vals)/N*1e3:8.3f} ms")

    mids = jax.random.uniform(key, (B, K, 3), jnp.float32, -0.9, 0.9)

    @jax.jit
    def f_vox(m):
        def body(_, acc):
            vi = get_voxel(grid, m)
            fl, va = voxel_flat_index(grid, vi)
            return acc + fl
        return jax.lax.fori_loop(0, N, body, jnp.zeros((B, K), jnp.int32))
    print(f"get_voxel [B,K]        {timed(f_vox, mids)/N*1e3:8.3f} ms")


if __name__ == "__main__":
    main()
