"""Low-discrepancy (quasi-Monte Carlo) sequences for source sampling.

The reference carries a Halton radical-inverse generator
(reference: src/random_mod.f90:9-42, ``seq``/``next``) seeded per thread
with bases 2 and 3 (kernelsMod.f90:1853-1854) but never actually uses it
(the call in the uniform source is commented out, photon.f90:608-609).
Here it is implemented properly, wavefront-style: a *counter-based* radical
inverse keyed by the global photon index (so it composes with the
wavefront respawn scheme and with photon sharding across devices), plus a
Cranley-Patterson rotation per dimension so independent replicates stay
unbiased and variance is estimable.

Used for the SOURCE uniform block only (position/direction/wavelength
stratification); the transport decisions stay threefry -- stratifying a
branching random walk beyond its first coordinates has vanishing benefit
and would correlate lanes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# first primes: one base per source-sampling dimension
PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def radical_inverse(idx: jnp.ndarray, base: int) -> jnp.ndarray:
    """Van der Corput radical inverse of ``idx`` (int32 >= 0) in ``base``
    (reference random_mod.f90:23-42), vectorised.  f32 in [0, 1)."""
    if base == 2:
        # full 32-bit reversal; f32 keeps the leading 24 bits, plenty for
        # any per-device photon stream
        m = jnp.uint32
        b = idx.astype(jnp.uint32)
        b = (b >> 16) | (b << 16)
        b = ((b & m(0xFF00FF00)) >> 8) | ((b & m(0x00FF00FF)) << 8)
        b = ((b & m(0xF0F0F0F0)) >> 4) | ((b & m(0x0F0F0F0F)) << 4)
        b = ((b & m(0xCCCCCCCC)) >> 2) | ((b & m(0x33333333)) << 2)
        b = ((b & m(0xAAAAAAAA)) >> 1) | ((b & m(0x55555555)) << 1)
        return b.astype(jnp.float32) * jnp.float32(2.0 ** -32)
    # generic base: peel ~ceil(log_base(2^24)) digits, unrolled
    n_digits = 1
    cap = base
    while cap < (1 << 24):
        cap *= base
        n_digits += 1
    inv_base = jnp.float32(1.0 / base)
    x = jnp.zeros(idx.shape, jnp.float32)
    f = inv_base
    cur = idx
    for _ in range(n_digits):
        digit = jnp.mod(cur, base)
        x = x + digit.astype(jnp.float32) * f
        cur = cur // base
        f = f * inv_base
    return x


def halton_block(idx: jnp.ndarray, n_dims: int, key) -> jnp.ndarray:
    """``[B, n_dims]`` scrambled-Halton uniforms for global photon indices
    ``idx [B]``: per-dimension radical inverse + Cranley-Patterson
    rotation drawn from ``key`` (rotation keeps the estimator unbiased
    across replicates while preserving low discrepancy)."""
    if n_dims > len(PRIMES):
        raise ValueError(f"halton_block supports <= {len(PRIMES)} dims")
    shifts = jax.random.uniform(key, (n_dims,), jnp.float32)
    cols = [
        jnp.mod(radical_inverse(idx, PRIMES[d]) + shifts[d], 1.0)
        for d in range(n_dims)
    ]
    u = jnp.stack(cols, axis=-1)
    # transport code divides by / takes logs of uniforms: keep u in
    # (0, 1] like jax.random.uniform(minval=1e-12) does in the engine
    return jnp.clip(1.0 - u, 1e-12, 1.0)
