"""Multi-host photon sharding (BASELINE.md "1 chip / 1 host / >=2 hosts").

Reference: the MPI rank reduction (src/kernelsMod.f90:2351-2357,
fpm.toml:23 ``mpi_f08``) -- every rank simulates its share of the photon
budget and the tally grids are SUM-reduced to rank 0 at the end.

Here every host process calls :func:`initialize` (``jax.distributed``),
the device mesh spans ALL processes' devices (`jax.devices()` is global
after init), photons shard over that mesh (pure data parallelism),
per-device RNG keys fold the *global* device index (fixing the
reference's un-offset MPI rank seeds, kernelsMod.f90:1846-1851), and
tallies reduce with one jitted sum whose output is replicated on every
process.  Between processes only the final reduction and the tiny
per-chunk status scalars travel -- the same communication shape as the
reference's end-of-run ``mpi_reduce``.

Tested with 2 CPU processes (local distributed backend) in
tests/test_distributed.py; the single-process path is identical to
``parallel.mesh.simulate_sharded_chunked``.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..transport.engine import TransportConfig, init_carry
from .mesh import _check_sharded_cfg, _chunk_sharded


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, **kw):
    """``jax.distributed.initialize`` passthrough.  With no arguments jax
    auto-detects the cluster (SLURM, Open MPI); pass explicit values
    (``coordinator_address="localhost:<port>"``, ``num_processes``,
    ``process_id``) for manual process launch."""
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id, **kw)


def global_mesh(axis: str = "dp") -> Mesh:
    """1D mesh over every device of every connected process."""
    return Mesh(np.array(jax.devices()), (axis,))


def simulate_distributed(scene, source, grid, key, cfg: TransportConfig,
                         bank=None, mesh: Mesh | None = None,
                         chunk_steps: int = 512, nphotons=None,
                         progress=None):
    """Chunked forward simulation over a (possibly multi-process) mesh.

    Every process executes the same SPMD program: carries live sharded
    ``P('dp')`` across the global mesh, a bounded-step chunk advances all
    devices, and a replicated status reduction decides termination
    identically on every process (no host-side access to remote shards).
    Returns (tallies, bank, launched, steps) fully reduced and replicated
    -- the reference's post-``mpi_reduce`` rank-0 state, on every rank.
    """
    _check_sharded_cfg(cfg)
    if mesh is None:
        mesh = global_mesh()
    n_dev = int(np.prod(mesh.devices.shape))
    n_target = int(cfg.nphotons if nphotons is None else nphotons)
    per_dev = math.ceil(n_target / n_dev)
    shard = NamedSharding(mesh, P("dp"))
    rep = NamedSharding(mesh, P())
    dtype = scene.tables.mus.dtype

    def _mk(key):
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
            jnp.arange(n_dev)
        )
        carry = init_carry(grid, cfg, bank=bank, dtype=dtype)
        carry = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x[None], (n_dev,) + x.shape),
            carry,
        )
        return keys, carry

    keys, carry = jax.jit(_mk, out_shardings=(shard, shard))(key)

    @partial(jax.jit, out_shardings=(rep, rep, rep, rep))
    def _status(carry):
        return (jnp.sum(carry.launched), jnp.max(carry.step),
                jnp.any(carry.state.alive), jnp.min(carry.launched))

    while True:
        carry = _chunk_sharded(scene, source, grid, keys, carry, cfg,
                               chunk_steps, per_dev, mesh)
        tot, step_max, any_alive, min_l = jax.device_get(_status(carry))
        if progress is not None:
            progress(int(tot), n_target, int(step_max), carry)
        if int(min_l) >= per_dev and not bool(any_alive):
            break
        if int(step_max) >= cfg.max_steps:
            break

    @partial(jax.jit, out_shardings=rep)
    def _reduce(carry):
        tallies = jax.tree_util.tree_map(lambda x: jnp.sum(x, axis=0),
                                         carry.tallies)
        bank_out = carry.bank
        if bank_out is not None:
            def fam(f):
                if f is None:
                    return None
                return dataclasses.replace(
                    f,
                    **{name: (jnp.sum(getattr(f, name), axis=0)
                              if name == "data"
                              else getattr(f, name)[0])
                       for name in [fl.name for fl in
                                    dataclasses.fields(type(f))
                                    if not fl.metadata.get("static")]},
                )

            bank_out = dataclasses.replace(
                bank_out,
                circle=fam(bank_out.circle),
                annulus=fam(bank_out.annulus),
                fibre=fam(bank_out.fibre),
                camera=fam(bank_out.camera),
                target_values=bank_out.target_values[0],
            )
        return (tallies, bank_out, jnp.sum(carry.launched),
                jnp.max(carry.step))

    return _reduce(carry)
