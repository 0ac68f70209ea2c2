"""Cartesian and cylindrical tally grids.

Vectorised version of the reference grid module (reference: src/grid.f90).
Grids are uniform, so voxel lookup and wall distances are closed-form --
no face arrays needed (the reference stores xface/yface/zface but its fast
path is the same floor expression, src/inttau2.f90:605-608).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp

from .constants import TWOPI


@jax.tree_util.register_dataclass
@dataclass
class CartGrid:
    """Uniform cartesian grid, half extents (xmax, ymax, zmax), voxel counts
    (nxg, nyg, nzg) (reference: src/grid.f90:14-29)."""

    xmax: jnp.ndarray
    ymax: jnp.ndarray
    zmax: jnp.ndarray
    nxg: int = field(metadata=dict(static=True))
    nyg: int = field(metadata=dict(static=True))
    nzg: int = field(metadata=dict(static=True))

    @property
    def shape(self):
        return (self.nxg, self.nyg, self.nzg)

    @property
    def half_extent(self):
        return jnp.stack([self.xmax, self.ymax, self.zmax])

    @property
    def voxel_size(self):
        return jnp.stack(
            [
                2.0 * self.xmax / self.nxg,
                2.0 * self.ymax / self.nyg,
                2.0 * self.zmax / self.nzg,
            ]
        )

    @property
    def n_counts(self):
        return jnp.asarray([self.nxg, self.nyg, self.nzg], jnp.int32)


def cart_grid(nxg, nyg, nzg, xmax, ymax, zmax, dtype=jnp.float32) -> CartGrid:
    return CartGrid(
        xmax=jnp.asarray(xmax, dtype),
        ymax=jnp.asarray(ymax, dtype),
        zmax=jnp.asarray(zmax, dtype),
        nxg=int(nxg),
        nyg=int(nyg),
        nzg=int(nzg),
    )


def get_voxel(grid: CartGrid, pos: jnp.ndarray) -> jnp.ndarray:
    """0-based voxel index ``[..., 3]``; -1 on any axis means outside
    (reference get_voxel_cart returns 1-based with -1 sentinel,
    src/grid.f90:51-78)."""
    half = grid.half_extent
    counts = grid.n_counts
    idx = jnp.floor(
        counts * (pos + half) / (2.0 * half)
    ).astype(jnp.int32)
    bad = jnp.logical_or(idx < 0, idx >= counts)
    return jnp.where(bad, -1, idx)


def voxel_flat_index(grid: CartGrid, idx: jnp.ndarray) -> jnp.ndarray:
    """Flatten ``[..., 3]`` voxel indices; invalid voxels map to index 0 with
    a False mask returned alongside."""
    valid = jnp.all(idx >= 0, axis=-1)
    safe = jnp.maximum(idx, 0)
    flat = (safe[..., 0] * grid.nyg + safe[..., 1]) * grid.nzg + safe[..., 2]
    return jnp.where(valid, flat, 0), valid


def wall_distance(grid: CartGrid, pos: jnp.ndarray,
                  direction: jnp.ndarray) -> jnp.ndarray:
    """Distance along ``direction`` to the nearest voxel wall
    (reference wall_dist, src/inttau2.f90:467-521).  Uniform grid: the wall
    coordinates are ``cell*dv`` and ``(cell+1)*dv`` in corner-origin
    coordinates."""
    half = grid.half_extent
    dv = grid.voxel_size
    pc = pos + half  # corner-origin coordinates
    cell = jnp.floor(pc / dv)
    big = jnp.asarray(1e5, pos.dtype)
    d_pos = ((cell + 1.0) * dv - pc) / jnp.where(direction == 0.0, 1.0,
                                                 direction)
    d_neg = (cell * dv - pc) / jnp.where(direction == 0.0, 1.0, direction)
    d = jnp.where(direction > 0.0, d_pos,
                  jnp.where(direction < 0.0, d_neg, big))
    d = jnp.maximum(d, 0.0)
    return jnp.min(d, axis=-1)


@jax.tree_util.register_dataclass
@dataclass
class CylGrid:
    """Cylindrical grid for escape-function symmetry
    (reference: src/grid.f90:31-43, tmax forced to 2*pi at init :173)."""

    rmax: jnp.ndarray
    zmax: jnp.ndarray
    nrg: int = field(metadata=dict(static=True))
    ntg: int = field(metadata=dict(static=True))
    nzg: int = field(metadata=dict(static=True))

    @property
    def tmax(self):
        return jnp.asarray(TWOPI, jnp.result_type(self.rmax))


def cyl_grid(nrg, ntg, nzg, rmax, tmax, zmax, dtype=jnp.float32) -> CylGrid:
    # tmax argument accepted for API parity but forced to 2*pi like the
    # reference (src/grid.f90:173)
    del tmax
    return CylGrid(
        rmax=jnp.asarray(rmax, dtype),
        zmax=jnp.asarray(zmax, dtype),
        nrg=int(nrg),
        ntg=int(ntg),
        nzg=int(nzg),
    )


def get_voxel_cyl(grid: CylGrid, pos: jnp.ndarray) -> jnp.ndarray:
    """reference: src/grid.f90:80-117"""
    rad = jnp.sqrt(pos[..., 0] ** 2 + pos[..., 1] ** 2)
    theta = jnp.where(
        rad == 0.0, 0.0, jnp.arctan2(pos[..., 1], pos[..., 0])
    )
    theta = jnp.where(theta < 0.0, theta + TWOPI, theta)
    ir = jnp.floor(grid.nrg * rad / grid.rmax).astype(jnp.int32)
    it = jnp.floor(grid.ntg * theta / grid.tmax).astype(jnp.int32)
    iz = jnp.floor(
        grid.nzg * (pos[..., 2] + grid.zmax) / (2.0 * grid.zmax)
    ).astype(jnp.int32)
    idx = jnp.stack([ir, it, iz], axis=-1)
    counts = jnp.asarray([grid.nrg, grid.ntg, grid.nzg], jnp.int32)
    bad = jnp.logical_or(idx < 0, idx >= counts)
    return jnp.where(bad, -1, idx)
