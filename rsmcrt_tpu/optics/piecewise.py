"""PBRT-style piecewise distribution sampling.

Vectorised version of the reference's piecewise module
(reference: src/opticalProps/piecewise.f90).  Three samplers:

- ``Constant``  -- single value (reference: :44-50, :93-107)
- ``Piecewise1D`` -- trapezoid-rule CDF, inverse-CDF sampling with linear
  interpolation, plus y-at-x lookup (reference: :53-61, :109-168)
- ``Piecewise2D`` -- image-based 2D sampling.  The reference builds its CDF
  in Morton (z-order) order purely as a CPU-cache trick (:193-244); here a
  plain row-major CDF over the flattened image is the natural layout and is
  statistically identical, so we use that.

All samplers are vectorised: they consume a batch of uniforms ``[B]`` and
return a batch of samples.  Searches are branch-free ``searchsorted`` calls
rather than scalar bisection loops (reference: :262-312).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclass
class Constant:
    value: jnp.ndarray


@jax.tree_util.register_dataclass
@dataclass
class Piecewise1D:
    """x/y table with precomputed CDF (reference: piecewise.f90:142-168)."""

    x: jnp.ndarray  # [n]
    y: jnp.ndarray  # [n]
    cdf: jnp.ndarray  # [n], cdf[0] = 0, cdf[-1] = 1


@jax.tree_util.register_dataclass
@dataclass
class Piecewise2D:
    """Image-based sampler (reference: piecewise.f90:64-76, :171-244)."""

    cdf: jnp.ndarray  # [h*w] flattened row-major CDF
    width: int
    height: int
    cell_width: jnp.ndarray
    cell_height: jnp.ndarray


def _trapz_cdf(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """CDF via the trapezoid rule, normalised (reference uses stdlib
    trapz_weights, piecewise.f90:159-167)."""
    seg = 0.5 * (y[1:] + y[:-1]) * np.diff(x)
    cdf = np.concatenate([[0.0], np.cumsum(seg)])
    # an all-zero table is legitimate for y-at-x lookup (spectral
    # property curves); only guard the division so the degenerate CDF
    # stays finite
    return cdf / max(cdf[-1], 1e-300)


def piecewise1d(array: np.ndarray) -> Piecewise1D:
    """Build from an (n, 2) array: column 0 = x, column 1 = y."""
    array = np.asarray(array, dtype=np.float64)
    if array.ndim != 2 or array.shape[1] != 2:
        raise ValueError("Array must be size (n, 2)")
    x, y = array[:, 0], array[:, 1]
    cdf = _trapz_cdf(x, y)
    return Piecewise1D(
        x=jnp.asarray(x, jnp.float32),
        y=jnp.asarray(y, jnp.float32),
        cdf=jnp.asarray(cdf, jnp.float32),
    )


def sample_piecewise1d(tab: Piecewise1D, u: jnp.ndarray) -> jnp.ndarray:
    """Inverse-CDF sample x values for uniforms ``u`` in [0, 1)
    (reference: piecewise.f90:124-131)."""
    idx = jnp.clip(jnp.searchsorted(tab.cdf, u, side="right") - 1, 0,
                   tab.cdf.shape[0] - 2)
    c0 = tab.cdf[idx]
    c1 = tab.cdf[idx + 1]
    x0 = tab.x[idx]
    x1 = tab.x[idx + 1]
    frac = (u - c0) / jnp.where(c1 > c0, c1 - c0, 1.0)
    return x0 + frac * (x1 - x0)


def sample_piecewise1d_at(tab: Piecewise1D, x: jnp.ndarray) -> jnp.ndarray:
    """y value at given x by linear interpolation
    (reference: piecewise.f90:133-137)."""
    idx = jnp.clip(jnp.searchsorted(tab.x, x, side="right") - 1, 0,
                   tab.x.shape[0] - 2)
    x0 = tab.x[idx]
    x1 = tab.x[idx + 1]
    y0 = tab.y[idx]
    y1 = tab.y[idx + 1]
    frac = (x - x0) / jnp.where(x1 > x0, x1 - x0, 1.0)
    return y0 + frac * (y1 - y0)


def piecewise2d(cell_width: float, cell_height: float,
                image: np.ndarray) -> Piecewise2D:
    """Build a 2D sampler from an image.  Uses a row-major flattened CDF
    (statistically identical to the reference's Morton-order CDF,
    piecewise.f90:193-244)."""
    image = np.asarray(image, dtype=np.float64)
    if not np.any(image > 0.0):
        raise ValueError(
            "piecewise2d image has no positive intensity: cannot build a "
            "sampling CDF (blank spectrum/SLM image)"
        )
    flat = image.reshape(-1)
    cdf = np.cumsum(flat)
    cdf = cdf / cdf[-1]
    return Piecewise2D(
        cdf=jnp.asarray(cdf, jnp.float32),
        width=image.shape[0],
        height=image.shape[1],
        cell_width=jnp.asarray(cell_width, jnp.float32),
        cell_height=jnp.asarray(cell_height, jnp.float32),
    )


def sample_piecewise2d(tab: Piecewise2D, u: jnp.ndarray, ux: jnp.ndarray,
                       uy: jnp.ndarray):
    """Sample pixel coordinates; ``u`` selects the pixel from the CDF and
    ``ux, uy`` jitter within the cell (reference: piecewise.f90:171-190,
    which offsets by uniform(-cell, +cell))."""
    idx = jnp.clip(jnp.searchsorted(tab.cdf, u, side="right"), 0,
                   tab.cdf.shape[0] - 1)
    xr = (idx // tab.height).astype(jnp.float32)
    yr = (idx % tab.height).astype(jnp.float32)
    x = xr + (2.0 * ux - 1.0) * tab.cell_width
    y = yr + (2.0 * uy - 1.0) * tab.cell_height
    return x, y
