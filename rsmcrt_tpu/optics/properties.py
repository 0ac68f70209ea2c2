"""Optical properties.

Redesign of the reference's polymorphic optical property classes
(reference: src/opticalProps/opticalProperties.f90).  An ``OptProps`` is a
flat differentiable pytree of the four *independent* quantities
(mus, mua, hgg, n); the derived kappa / albedo / g2 are computed lazily so
gradients flow (reference derives them at init, :107-125).

``SpectralOptProps`` carries piecewise-1D tables for each quantity plus an
emission flux spectrum; ``sample_spectral`` resamples all of them at a
wavelength drawn from the flux CDF (reference: :127-156, :171-201).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp

from .piecewise import Piecewise1D, sample_piecewise1d_at


@jax.tree_util.register_dataclass
@dataclass
class OptProps:
    """Monochromatic optical properties (reference ``mono`` type)."""

    mus: jnp.ndarray
    mua: jnp.ndarray
    hgg: jnp.ndarray
    n: jnp.ndarray

    @property
    def kappa(self):
        return self.mus + self.mua

    @property
    def albedo(self):
        # reference: albedo = 1 when mua < 1e-9 (opticalProperties.f90:115-119)
        kappa = self.kappa
        safe = jnp.where(kappa > 0.0, kappa, 1.0)
        return jnp.where(self.mua < 1e-9, 1.0, self.mus / safe)

    @property
    def g2(self):
        return self.hgg * self.hgg


def mono(mus, mua, hgg, n, dtype=jnp.float32) -> OptProps:
    as_arr = lambda v: jnp.asarray(v, dtype=dtype)
    return OptProps(as_arr(mus), as_arr(mua), as_arr(hgg), as_arr(n))


@jax.tree_util.register_dataclass
@dataclass
class SpectralOptProps:
    """Wavelength dependent optical properties (reference ``spectral``)."""

    mus_tab: Piecewise1D
    mua_tab: Piecewise1D
    hgg_tab: Piecewise1D
    n_tab: Piecewise1D
    flux: Piecewise1D

    def at_wavelength(self, wavelength) -> OptProps:
        """Resample every property at ``wavelength``
        (reference: opticalProperties.f90:171-201)."""
        return OptProps(
            mus=sample_piecewise1d_at(self.mus_tab, wavelength),
            mua=sample_piecewise1d_at(self.mua_tab, wavelength),
            hgg=sample_piecewise1d_at(self.hgg_tab, wavelength),
            n=sample_piecewise1d_at(self.n_tab, wavelength),
        )
