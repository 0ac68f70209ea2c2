"""Shared microbenchmark timing helper.

Every timed region ends with a host read of the result (a device-side
reduction to a scalar followed by a host transfer), which cannot complete
before the timed computation has.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp


def host_sync(x) -> float:
    """Force a host read of (the first leaf of) ``x``.

    Returns a float so callers can also use it as a cheap checksum.  The
    reduction runs on device; ``float()`` blocks the host until the value
    arrives, which orders after all prior device work on that buffer.
    """
    leaf = jax.tree_util.tree_leaves(x)[0]
    return float(jnp.sum(leaf))


def timed(fn, *args, reps: int = 5, warmup: int = 2) -> float:
    """Minimum wall time of ``fn(*args)`` over ``reps`` repetitions,
    synchronized with a host read."""
    for _ in range(warmup):
        host_sync(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        host_sync(fn(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts)
