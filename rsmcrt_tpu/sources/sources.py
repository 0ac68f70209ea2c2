"""Photon source sampling.

Vectorised redesign of the reference launch routines
(reference: src/photon.f90:159-1043).  A :class:`Source` is a pytree of
parameters with a static ``kind``; ``sample`` consumes a block of uniforms
``u [B, 8]`` and emits a whole wavefront of photons at once.  Fixed
rotation/translation matrices are precomputed at build time (the reference
rebuilds them per photon, e.g. photon.f90:436-473).

Sources: uniform, pencil, dslit, aperture, annulus, focus, point, circular,
slm.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import TWOPI
from ..grid import CartGrid
from ..maths import transforms as T
from ..optics.piecewise import (
    Constant,
    Piecewise1D,
    Piecewise2D,
    sample_piecewise1d,
    sample_piecewise2d,
)

N_SOURCE_UNIFORMS = 8

# uniforms actually consumed per source kind (static; lets the transport
# engine draw exactly what the megastep needs -- RNG generation is a fixed
# per-step cost proportional to the column count)
SOURCE_UNIFORM_COUNT = {
    "escape_points": 3,
    "point": 3,
    "pencil": 1,
    "uniform": 3,
    "circular": 3,
    "focus": 3,
    "annulus": 5,
    "dslit": 6,
    "aperture": 5,
    "slm": 3,
}


def n_source_uniforms(source: "Source") -> int:
    n = SOURCE_UNIFORM_COUNT.get(source.kind, N_SOURCE_UNIFORMS)
    if isinstance(source.spectrum, Piecewise2D):
        # 2D image spectra draw two extra in-cell jitter uniforms
        # (reference sample2D, piecewise.f90:171-190)
        n += 2
    return n


@jax.tree_util.register_dataclass
@dataclass
class Source:
    kind: str = field(metadata=dict(static=True))
    params: dict = field(default_factory=dict)
    spectrum: object = None  # Constant | Piecewise1D | Piecewise2D
    subtype: str = field(metadata=dict(static=True), default="")


def _normalise(v):
    return v / jnp.linalg.norm(v)


def _spectrum_sample(spectrum, u, u_full=None):
    """Sample a wavelength per lane.  ``u`` is the selection uniform;
    2D image spectra additionally consume the last two columns of
    ``u_full`` as in-cell jitter (the reference's photon emitters use
    the x coordinate of the 2D sample as the wavelength,
    photon.f90:293/:347 with sample2D, piecewise.f90:171-190)."""
    if spectrum is None:
        return jnp.full_like(u, 500.0)
    if isinstance(spectrum, Constant):
        return jnp.broadcast_to(spectrum.value, u.shape)
    if isinstance(spectrum, Piecewise1D):
        return sample_piecewise1d(spectrum, u)
    if isinstance(spectrum, Piecewise2D):
        if u_full is not None and u_full.shape[-1] >= 2:
            ux, uy = u_full[:, -2], u_full[:, -1]
        else:
            ux = uy = jnp.full_like(u, 0.5)
        x, _ = sample_piecewise2d(spectrum, u, ux, uy)
        return x
    raise TypeError(f"cannot sample wavelength from {type(spectrum)}")


def _edge_nudge(pos, grid: CartGrid, shift):
    """Push photons launched exactly on a grid face just inside
    (reference: photon.f90:271-285, 614-628, 671-685; it uses 7.9e-7 which
    is below f32 ulp at 1.0, so we scale with dtype)."""
    half = grid.half_extent
    pos = jnp.where(pos == -half, pos + shift, pos)
    pos = jnp.where(pos == half, pos - shift, pos)
    return pos


def _walk_into_grid(pos, direction, grid: CartGrid, shift):
    """Step a photon launched outside the grid along its direction until it
    is inside (reference: photon.f90:502-556 / :982-1036, bounded at ~5
    tries)."""
    half = grid.half_extent
    safe_dir = jnp.where(direction == 0.0, 1e-12, direction)
    for _ in range(5):
        below = pos <= -half
        above = pos >= half
        target = jnp.where(below, -half + shift, half - shift)
        step = (target - pos) / safe_dir
        step = jnp.where(below | above, step, 0.0)
        # apply one axis at a time like the reference (x, then y, then z)
        for ax in range(3):
            s = step[..., ax]
            moved = pos + s[..., None] * direction
            pos = jnp.where((below | above)[..., ax, None], moved, pos)
            below = pos <= -half
            above = pos >= half
            target = jnp.where(below, -half + shift, half - shift)
            step = (target - pos) / safe_dir
            step = jnp.where(below | above, step, 0.0)
    return pos


def _coherent_launch(dx, dy, dz):
    """Direction + launch phase for the coherent slit/aperture sources.

    The reference stores the full slit->screen distance as the phase
    (photon.f90:747/:826) in float64.  In float32 that distance (~10
    scene units) has an ulp of ~2 wavelengths, which decoheres/aliases
    the fringes, so we store the *transverse excess* t2/(dist+|dz|) --
    the full distance minus the batch-constant axial distance |dz|,
    computed cancellation-free.  A per-wavelength-constant phase offset
    cancels in |E|^2, so fringe patterns are identical.
    """
    t2 = dx * dx + dy * dy
    adz = jnp.abs(dz)
    dist = jnp.sqrt(t2 + dz * dz)
    phase = t2 / (dist + adz)
    direction = jnp.stack([dx / dist, dy / dist, -adz / dist], axis=-1)
    return direction, phase


def _focus_annulus_frame(position, rotation, dtype):
    """Shared frame construction for the focus and annulus sources
    (reference: photon.f90:436-475 / :918-957)."""
    a = jnp.asarray([0.0, 0.0, -1.0], dtype)
    b = _normalise(jnp.asarray(rotation, dtype))
    start = -jnp.asarray(position, dtype)
    # trace-safe (params may be jit tracers): select between the Rodrigues
    # alignment and the b = -a mirror case, where rotation_align is
    # singular (1/(1+c) with c = a.b = -1)
    c = jnp.sum(a * b)
    mirrored = c < -1.0 + 1e-6
    b_safe = jnp.where(mirrored, -b, b)
    t_rot = T.rotation_align(a, b_safe)
    t_mirror = jnp.diag(jnp.asarray([1.0, 1.0, -1.0, 1.0], dtype))
    t_dir = jnp.where(mirrored, t_mirror, t_rot)
    # reference resets t(3,3)=1 for the *position* transform (:469-471)
    t = jnp.where(mirrored, t_mirror.at[2, 2].set(1.0), t_rot)
    t_pos = T.matmul(t, T.invert(T.translate(start)))
    return t_pos, t_dir


def build_source(kind: str, spectrum=None, dtype=jnp.float32,
                 **params) -> Source:
    p = {}
    subtype = ""
    for k, v in params.items():
        if v is None:
            continue
        if isinstance(v, str):
            # beam subtypes (focus_type / annulus_type) are static
            subtype = v
        else:
            p[k] = jnp.asarray(v, dtype)
    return Source(kind=kind, params=p, spectrum=spectrum, subtype=subtype)


def sample(source: Source, grid: CartGrid, u: jnp.ndarray, sid=None):
    """Emit a wavefront.  ``u [B, N_SOURCE_UNIFORMS]`` uniforms in [0,1).

    Returns (pos [B,3], dir [B,3], phase [B], wavelength [B]).  ``sid`` is
    the per-lane source-voxel index used by the "escape_points" source.
    """
    kind = source.kind
    p = source.params
    dtype = u.dtype
    B = u.shape[0]
    shift = jnp.asarray(8e-6 if dtype == jnp.float32 else 7.9e-7, dtype)

    wavelength = None
    phase = jnp.zeros((B,), dtype)

    if kind == "escape_points":
        # batched isotropic point sources at precomputed voxel centres --
        # the batched version of the reference escape-function per-voxel
        # loop (kernelsMod.f90:167-184, :599-607)
        phi = u[:, 0] * TWOPI
        cost = 2.0 * u[:, 1] - 1.0
        sint = jnp.sqrt(jnp.maximum(1.0 - cost * cost, 0.0))
        direction = jnp.stack(
            [sint * jnp.cos(phi), sint * jnp.sin(phi), cost], axis=-1
        )
        positions = p["positions"]  # [M, 3]
        idx = jnp.clip(sid, 0, positions.shape[0] - 1)
        pos = positions[idx]
        wavelength = _spectrum_sample(source.spectrum, u[:, 2], u)

    elif kind == "point":
        # reference: photon.f90:311-359
        phi = u[:, 0] * TWOPI
        cost = 2.0 * u[:, 1] - 1.0
        sint = jnp.sqrt(jnp.maximum(1.0 - cost * cost, 0.0))
        direction = jnp.stack(
            [sint * jnp.cos(phi), sint * jnp.sin(phi), cost], axis=-1
        )
        pos = jnp.broadcast_to(p["position"], (B, 3))
        wavelength = _spectrum_sample(source.spectrum, u[:, 2], u)

    elif kind == "pencil":
        # reference: photon.f90:652-710
        pos = jnp.broadcast_to(p["position"], (B, 3))
        pos = _edge_nudge(pos, grid, shift)
        direction = jnp.broadcast_to(_normalise(p["direction"]), (B, 3))
        wavelength = _spectrum_sample(source.spectrum, u[:, 0], u)

    elif kind == "uniform":
        # reference: photon.f90:566-649; pos = p1 + rx*p2 + ry*p3
        rx = u[:, 0:1]
        ry = u[:, 1:2]
        pos = p["point1"] + rx * p["point2"] + ry * p["point3"]
        pos = _edge_nudge(pos, grid, shift)
        direction = jnp.broadcast_to(_normalise(p["direction"]), (B, 3))
        wavelength = _spectrum_sample(source.spectrum, u[:, 2], u)

    elif kind == "circular":
        # reference: photon.f90:214-308
        radius = p["radius"]
        r = radius * jnp.sqrt(u[:, 0])
        theta = u[:, 1] * TWOPI
        b = _normalise(p["direction"])
        a = jnp.asarray([1.0, 0.0, 0.0], dtype)
        mirrored = bool(
            np.allclose(np.abs(np.asarray(b)), np.abs(np.asarray(a)))
        )
        if mirrored:
            a = jnp.asarray([0.0, 0.0, 1.0], dtype)
            local = jnp.stack(
                [r * jnp.cos(theta), r * jnp.sin(theta), jnp.zeros_like(r)],
                axis=-1,
            )
        else:
            local = jnp.stack(
                [jnp.zeros_like(r), r * jnp.cos(theta), r * jnp.sin(theta)],
                axis=-1,
            )
        t = T.matmul(T.rotation_align(a, b),
                     T.invert(T.translate(p["position"])))
        pos = -T.apply_transform(t, local)
        pos = _edge_nudge(pos, grid, shift)
        direction = jnp.broadcast_to(b, (B, 3))
        wavelength = _spectrum_sample(source.spectrum, u[:, 2], u)

    elif kind == "focus":
        # reference: photon.f90:361-563
        beam_size = p["beam_size"]
        ftype = source.subtype or "gaussian"
        if ftype == "square":
            x = (2.0 * u[:, 0] - 1.0) * beam_size
            y = (2.0 * u[:, 1] - 1.0) * beam_size
        elif ftype == "circle":
            radius = beam_size * jnp.sqrt(u[:, 0])
            phi = TWOPI * u[:, 1]
            x = radius * jnp.cos(phi)
            y = radius * jnp.sin(phi)
        elif ftype == "gaussian":
            # beam_size is the 1/e radius (reference :411-422)
            radius = beam_size * jnp.sqrt(-jnp.log(1.0 - u[:, 0]))
            phi = TWOPI * u[:, 1]
            x = radius * jnp.cos(phi)
            y = radius * jnp.sin(phi)
        else:
            raise ValueError(f"No such beam type {ftype!r}")
        local = jnp.stack([x, y, jnp.zeros_like(x)], axis=-1)
        fl = p["focalLength"]
        targ = jnp.stack([jnp.zeros_like(fl), jnp.zeros_like(fl), -fl])
        delta = local - targ
        dist = jnp.linalg.norm(delta, axis=-1, keepdims=True)
        direction = -delta / dist * jnp.sign(fl)
        t_pos, t_dir = _focus_annulus_frame(p["position"], p["rotation"],
                                            dtype)
        direction = _normalise_batch(T.apply_rotation(t_dir, direction))
        pos = T.apply_transform(t_pos, local)
        pos = _walk_into_grid(pos, direction, grid, 9e-7 if
                              dtype == jnp.float64 else 1e-5)
        wavelength = _spectrum_sample(source.spectrum, u[:, 2], u)

    elif kind == "annulus":
        # reference: photon.f90:850-1043
        rlo, rhi = p["rlo"], p["rhi"]
        btype = source.subtype or "gaussian"
        mid = (rhi + rlo) / 2.0
        if btype == "tophat":
            radius = jnp.sqrt(rlo**2 + (rhi**2 - rlo**2) * u[:, 0])
        elif btype == "besselAnnulus":
            radius = rlo + (rhi - rlo) * u[:, 0]
        elif btype == "gaussian":
            sigma = p["sigma"]
            r_gauss = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(u[:, 3], 1e-12)))
            radius = mid + sigma * r_gauss * jnp.cos(TWOPI * u[:, 4])
        else:
            raise ValueError(f"No such beam type {btype!r}")
        phi = TWOPI * u[:, 1]
        cosp, sinp = jnp.cos(phi), jnp.sin(phi)
        local = jnp.stack(
            [radius * cosp, radius * sinp, jnp.zeros_like(radius)], axis=-1
        )
        fl = p["focalLength"]
        targ = jnp.stack([jnp.zeros_like(fl), jnp.zeros_like(fl), -fl])
        midpt = jnp.stack(
            [mid * cosp, mid * sinp, jnp.zeros_like(cosp)], axis=-1
        )
        delta = midpt - targ
        dist = jnp.linalg.norm(delta, axis=-1, keepdims=True)
        direction = -delta / dist * jnp.sign(fl)
        t_pos, t_dir = _focus_annulus_frame(p["position"], p["rotation"],
                                            dtype)
        direction = _normalise_batch(T.apply_rotation(t_dir, direction))
        pos = T.apply_transform(t_pos, local)
        pos = _walk_into_grid(pos, direction, grid, 9e-7 if
                              dtype == jnp.float64 else 1e-5)
        wavelength = _spectrum_sample(source.spectrum, u[:, 2], u)

    elif kind == "dslit":
        # reference: photon.f90:712-780
        wavelength = _spectrum_sample(source.spectrum, u[:, 0], u)
        wl = wavelength
        a = 60.0 * wl
        b = 20.0 * wl
        right = u[:, 1] > 0.5
        x1_r = a / 2.0 + b * u[:, 2]
        x1_l = -a / 2.0 - b * u[:, 2]
        x1 = jnp.where(right, x1_r, x1_l)
        y1 = (u[:, 3] - 0.5) * b
        z2 = 5.0 - (1e-5 * (2.0 * (5.0 / 400.0)))
        x2 = (2.0 * u[:, 4] - 1.0) * 5.0
        y2 = (2.0 * u[:, 5] - 1.0) * 5.0
        z1 = (10000.0 * wl) - 5.0
        pos = jnp.stack([x2, y2, jnp.full_like(x2, z2)], axis=-1)
        direction, phase = _coherent_launch(x2 - x1, y2 - y1, z2 - z1)

    elif kind == "aperture":
        # reference: photon.f90:782-848
        wavelength = _spectrum_sample(source.spectrum, u[:, 0], u)
        wl = wavelength
        apwid = 200e-6
        b = apwid / 2.0
        fno = 4.95
        x1 = (2.0 * u[:, 1] - 1.0) * b
        y1 = (2.0 * u[:, 2] - 1.0) * b
        z1 = (1.0 / ((((fno / apwid) ** 2) / 2.0) * wl)) - 0.5
        x2 = u[:, 3] - 0.5
        y2 = u[:, 4] - 0.5
        z2 = 0.5 - (1e-5 * (2.0 * 0.5 / 400.0))
        pos = jnp.stack([x2, y2, jnp.full_like(x2, z2)], axis=-1)
        direction, phase = _coherent_launch(x2 - x1, y2 - y1, z2 - z1)

    elif kind == "slm":
        # reference: photon.f90:159-212 (2D image source; note the
        # hardcoded half-grid offset of 100 cells the reference carries)
        if not isinstance(source.spectrum, Piecewise2D):
            raise TypeError("slm source requires a 2D spectrum")
        x, y = sample_piecewise2d(source.spectrum, u[:, 0], u[:, 1], u[:, 2])
        base = jnp.broadcast_to(p["position"], (B, 3))
        sx = (x - 100.0) / (grid.nxg / (2.0 * grid.xmax))
        sy = (y - 100.0) / (grid.nyg / (2.0 * grid.ymax))
        pos = jnp.stack([sx, sy, base[:, 2]], axis=-1)
        direction = jnp.broadcast_to(_normalise(p["direction"]), (B, 3))
        wavelength = jnp.full((B,), 500e-9, dtype)

    else:
        raise ValueError(f"No such source {kind!r}")

    if wavelength is None:
        wavelength = jnp.full((B,), 500.0, dtype)
    return pos.astype(dtype), direction.astype(dtype), phase, wavelength


def _normalise_batch(v):
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    return v / jnp.where(n > 0.0, n, 1.0)
