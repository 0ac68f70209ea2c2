"""Physical and numerical constants.

Re-design of the reference constants module
(reference: src/constants.f90:18-30).  Unlike the reference (f64 transport,
f32 tallies) we default to f32 everywhere -- the accelerator's native
precision -- and scale the boundary-nudge epsilon accordingly.  f64 is
available for CPU validation runs via ``precision("f64")``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import jax.numpy as jnp

PI = math.pi
TWOPI = 2.0 * math.pi

#: Weight threshold for Russian roulette (reference: src/constants.f90:28).
THRESHOLD = 0.01
#: Survival probability in roulette (reference: src/constants.f90:30).
CHANCE = 0.1


@dataclass(frozen=True)
class Precision:
    """Floating point policy for the transport engine."""

    dtype: jnp.dtype
    #: Boundary round-off distance (reference uses 1e-8 in f64,
    #: src/inttau2.f90:56); in f32 that is below ulp near |pos|~1 so we widen.
    eps: float
    #: Normal finite-difference step (reference: src/sdfs/sdf_base.f90:177).
    normal_h: float

    @property
    def jnp_dtype(self):
        return self.dtype


def precision(kind: str = "f32") -> Precision:
    if kind in ("f32", "float32"):
        return Precision(dtype=jnp.float32, eps=1e-5, normal_h=1e-4)
    if kind in ("f64", "float64"):
        return Precision(dtype=jnp.float64, eps=1e-8, normal_h=1e-6)
    raise ValueError(f"unknown precision {kind!r}")
