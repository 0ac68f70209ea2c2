"""Detectors: circle, annulus, fibre (4f system), camera.

Wavefront redesign of the reference detector classes
(reference: src/detectors/detector_base.f90, src/detectors/detectors.f90).
Each detector family is a pytree with *stacked* parameters ``[M, ...]`` so
all detectors of a family test a whole wavefront of path segments in one
vectorised call; bins live in arrays updated by scatter-add instead of
``!$omp atomic`` (reference: detector_base.f90:155-157).

A "hit test" consumes a straight path segment (origin, direction, length,
weight) and returns (hit?, bin_value) exactly like the reference ``hit_t``
protocol (detector_base.f90:9-22).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import TWOPI


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def intersect_plane(n, p0, l0, l):
    """Ray/plane: returns (hit, t) (reference: src/geometryMod.f90:217-241,
    only front-side crossings with denom > 1e-6)."""
    denom = _dot(n, l)
    safe = jnp.where(jnp.abs(denom) > 0.0, denom, 1.0)
    t = _dot(p0 - l0, n) / safe
    hit = jnp.logical_and(denom > 1e-6, t > -1e-6)
    return hit, t


def intersect_circle(n, p0, radius, l0, l):
    """Ray/disc: (hit, t, d) with d the radial distance in the disc plane
    (reference: src/geometryMod.f90:244-270)."""
    hit_p, t = intersect_plane(n, p0, l0, l)
    p = l0 + l * t[..., None]
    d = jnp.sqrt(jnp.maximum(_dot(p - p0, p - p0), 0.0))
    return jnp.logical_and(hit_p, d <= radius), t, d


def intersect_sphere(orig, direction, centre, radius):
    """Ray/sphere smallest positive root (reference: geometryMod.f90:21-62)."""
    L = orig - centre
    a = _dot(direction, direction)
    b = 2.0 * _dot(direction, L)
    c = _dot(L, L) - radius**2
    return _solve_quadratic_smallest_positive(a, b, c)


def intersect_cylinder(orig, direction, centre, radius):
    """Infinite z-cylinder (reference: geometryMod.f90:64-108)."""
    L = orig - centre
    a = direction[..., 0] ** 2 + direction[..., 1] ** 2
    b = 2.0 * (direction[..., 0] * L[..., 0] + direction[..., 1] * L[..., 1])
    c = L[..., 0] ** 2 + L[..., 1] ** 2 - radius**2
    return _solve_quadratic_smallest_positive(a, b, c)


def intersect_ellipse(orig, direction, centre, semia, semib):
    """Infinite elliptical cylinder along x (reference:
    geometryMod.f90:111-161; z/y axes)."""
    L = orig - centre
    ia = 1.0 / semia**2
    ib = 1.0 / semib**2
    a = ia * direction[..., 2] ** 2 + ib * direction[..., 1] ** 2
    b = 2.0 * (ia * direction[..., 2] * L[..., 2]
               + ib * direction[..., 1] * L[..., 1])
    c = ia * L[..., 2] ** 2 + ib * L[..., 1] ** 2 - 1.0
    return _solve_quadratic_smallest_positive(a, b, c)


def intersect_cone(orig, direction, centre, radius, height):
    """Infinite cone along z (reference: geometryMod.f90:164-215)."""
    k = (radius / height) ** 2
    L = orig - centre
    a = direction[..., 0] ** 2 + direction[..., 1] ** 2 - k * direction[..., 2] ** 2
    b = 2.0 * (direction[..., 0] * L[..., 0] + direction[..., 1] * L[..., 1]
               - k * direction[..., 2] * (L[..., 2] - height))
    c = L[..., 0] ** 2 + L[..., 1] ** 2 - k * (L[..., 2] - height) ** 2
    return _solve_quadratic_smallest_positive(a, b, c)


def _solve_quadratic_smallest_positive(a, b, c):
    """(hit, t): smallest non-negative root (reference:
    geometryMod.f90:272-303 + root selection :47-58)."""
    discrim = b * b - 4.0 * a * c
    ok = discrim >= 0.0
    sq = jnp.sqrt(jnp.maximum(discrim, 0.0))
    q = jnp.where(b > 0.0, -0.5 * (b + sq), -0.5 * (b - sq))
    safe_a = jnp.where(a != 0.0, a, 1.0)
    safe_q = jnp.where(q != 0.0, q, 1.0)
    x0 = q / safe_a
    x1 = c / safe_q
    t0 = jnp.minimum(x0, x1)
    t1 = jnp.maximum(x0, x1)
    t = jnp.where(t0 < 0.0, t1, t0)
    hit = jnp.logical_and(ok, t >= 0.0)
    return hit, t


# ---------------------------------------------------------------------------
# Detector pytrees
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclass
class CircleDetectors:
    """Stacked circle detectors (reference: detectors.f90:13-24, :107-164)."""

    pos: jnp.ndarray  # [M, 3]
    dir: jnp.ndarray  # [M, 3]
    radius: jnp.ndarray  # [M]
    bin_wid: jnp.ndarray  # [M]
    data: jnp.ndarray  # [M, nbins+1]
    nbins: int = field(metadata=dict(static=True))
    # per-detector bin counts (<= nbins, which pads the family); None
    # means every member uses nbins (reference detectors each carry their
    # own nbins, detectors.f90:107-210)
    nbins_arr: jnp.ndarray = None

    def check_hit(self, o, d, seg_len):
        """o,d [B,3]; seg_len [B] -> (hit [B,M], value [B,M])."""
        hit, t, dist = intersect_circle(
            self.dir, self.pos, self.radius, o[:, None, :], d[:, None, :]
        )
        in_seg = jnp.logical_and(t > 0.0, t <= seg_len[:, None])
        return jnp.logical_and(hit, in_seg), dist


@jax.tree_util.register_dataclass
@dataclass
class AnnulusDetectors:
    """Stacked annular detectors (reference: detectors.f90:59-71,
    :166-244). Hits the r2 disc but not the r1 disc; bins r - r1."""

    pos: jnp.ndarray
    dir: jnp.ndarray
    r1: jnp.ndarray
    r2: jnp.ndarray
    bin_wid: jnp.ndarray
    data: jnp.ndarray
    nbins: int = field(metadata=dict(static=True))
    nbins_arr: jnp.ndarray = None  # per-detector bin counts

    def check_hit(self, o, d, seg_len):
        hit1, _, _ = intersect_circle(
            self.dir, self.pos, self.r1, o[:, None, :], d[:, None, :]
        )
        hit2, t, dist = intersect_circle(
            self.dir, self.pos, self.r2, o[:, None, :], d[:, None, :]
        )
        in_seg = jnp.logical_and(t > 0.0, t <= seg_len[:, None])
        hit = jnp.logical_and(jnp.logical_and(~hit1, hit2), in_seg)
        return hit, dist - self.r1


@jax.tree_util.register_dataclass
@dataclass
class FibreDetectors:
    """Stacked fibre detectors: 4f lens system traced with the thin-lens
    approximation (reference: detectors.f90:26-57, :246-393)."""

    pos: jnp.ndarray
    dir: jnp.ndarray
    focalLength1: jnp.ndarray
    focalLength2: jnp.ndarray
    f1Aperture: jnp.ndarray
    f2Aperture: jnp.ndarray
    frontOffset: jnp.ndarray
    backOffset: jnp.ndarray
    frontToPinSep: jnp.ndarray
    pinToBackSep: jnp.ndarray
    pinAperture: jnp.ndarray
    acceptAngle: jnp.ndarray
    coreDiameter: jnp.ndarray
    bin_wid: jnp.ndarray
    data: jnp.ndarray
    nbins: int = field(metadata=dict(static=True))
    nbins_arr: jnp.ndarray = None  # per-detector bin counts

    def check_hit(self, o, d, seg_len):
        lens_pos = self.pos + self.dir * self.frontOffset[:, None]
        hit, t, radius = intersect_circle(
            self.dir, lens_pos, self.f1Aperture, o[:, None, :],
            d[:, None, :]
        )
        in_seg = jnp.logical_and(t > 0.0, t <= seg_len[:, None])
        hit = jnp.logical_and(hit, in_seg)

        costt = jnp.clip(_dot(self.dir, d[:, None, :]), -1.0, 1.0)
        sintt = jnp.sqrt(jnp.maximum(1.0 - costt * costt, 0.0))
        gradient = sintt / jnp.where(costt != 0.0, costt, 1.0)
        # front lens (thin lens), then pinhole
        gradient = -radius / self.focalLength1 + gradient
        radius = radius + gradient * self.frontToPinSep
        hit = jnp.logical_and(hit, radius <= self.pinAperture)
        # to the back lens
        radius = radius + gradient * self.pinToBackSep
        hit = jnp.logical_and(hit, radius <= self.f2Aperture)
        gradient = -radius / self.focalLength2 + gradient
        # to the fibre face
        radius = radius + gradient * self.backOffset
        angle = jnp.abs(jnp.arctan(gradient)) * 360.0 / TWOPI
        hit = jnp.logical_and(hit, angle <= self.acceptAngle)
        hit = jnp.logical_and(hit, radius <= self.coreDiameter / 2.0)
        return hit, jnp.abs(radius)


@jax.tree_util.register_dataclass
@dataclass
class CameraDetectors:
    """Stacked rectangle ("camera") detectors
    (reference: detectors.f90:74-95, :395-469).  2D binning; adds counts,
    not weights (reference: detector_base.f90:229)."""

    pos: jnp.ndarray  # p1 corner [M, 3]
    n: jnp.ndarray
    e1: jnp.ndarray
    e2: jnp.ndarray
    width: jnp.ndarray
    height: jnp.ndarray
    bin_wid_x: jnp.ndarray
    bin_wid_y: jnp.ndarray
    data: jnp.ndarray  # [M, nbins+1, nbins+1]
    nbins: int = field(metadata=dict(static=True))
    nbins_arr: jnp.ndarray = None  # per-detector bin counts

    def check_hit(self, o, d, seg_len):
        denom = _dot(self.n, d[:, None, :])
        safe = jnp.where(denom != 0.0, denom, 1.0)
        t = _dot((self.pos - o[:, None, :]), self.n) / safe
        v = (o[:, None, :] + t[..., None] * d[:, None, :]) - self.pos
        proj1 = _dot(v, self.e1) / self.width
        proj2 = _dot(v, self.e2) / self.height
        hit = (t >= 0.0) & (denom != 0.0)
        hit &= (proj1 > 0.0) & (proj1 < self.width)
        hit &= (proj2 > 0.0) & (proj2 < self.height)
        # the reference camera puts NO upper bound on t (check_hit_camera
        # has no pointSep test, detectors.f90:447-469) -- kept -- but only
        # real segments may test at all, else idle wavefront lanes would
        # re-record phantom hits every megastep
        hit &= seg_len[:, None] > 0.0
        # 2D binning parity: the reference bins the SEGMENT START position
        # (hitpoint%pos is the pre-move startPos, inttau2.f90:195-200), not
        # the plane intersection point -- x = start.z + det.pos.x,
        # y = start.y + det.pos.y (detector_base.f90:222-223).  Kept
        # bug-for-bug; pinned by test_detectors.py camera goldens.
        hx = o[:, None, 2] + self.pos[:, 0]
        hy = o[:, None, 1] + self.pos[:, 1]
        return hit, (hx, hy)


@jax.tree_util.register_dataclass
@dataclass
class DetectorBank:
    """All detectors in a simulation, grouped by family.

    ``order`` maps user detector indices to (family, member) so outputs can
    be reported in config order; ``target_values`` feed the inverse kernel
    (reference: detector_base.f90:41-42)."""

    circle: Optional[CircleDetectors]
    annulus: Optional[AnnulusDetectors]
    fibre: Optional[FibreDetectors]
    camera: Optional[CameraDetectors]
    target_values: jnp.ndarray  # [n_dects]
    order: tuple = field(metadata=dict(static=True), default=())
    ids: tuple = field(metadata=dict(static=True), default=())
    layers: tuple = field(metadata=dict(static=True), default=())

    @property
    def n_detectors(self):
        return len(self.order)


def _bin_idx_1d(dect, value):
    """Reference 1D binning: round(value / bin_wid) clipped to the
    per-detector bin count (detector_base.f90:144-153)."""
    cap = (dect.nbins if dect.nbins_arr is None
           else dect.nbins_arr[None, :])
    idx = jnp.minimum(
        jnp.round(value / dect.bin_wid).astype(jnp.int32), cap
    )
    return jnp.maximum(idx, 0)


def _bin_idx_cam(cam, hx, hy):
    """Reference 2D camera binning flattened to one index
    (detector_base.f90:222-227 incl. the negative-wrap quirk)."""
    nb = cam.data.shape[1]
    cap = (nb - 1 if cam.nbins_arr is None else cam.nbins_arr[None, :])
    idx = jnp.minimum((hx / cam.bin_wid_x).astype(jnp.int32) + 1, cap)
    idy = jnp.minimum((hy / cam.bin_wid_y).astype(jnp.int32) + 1, cap)
    idx = jnp.where(idx < 1, cap, idx) - 1
    idy = jnp.where(idy < 1, cap, idy) - 1
    return idx * nb + idy


def check_bins(bank: DetectorBank, o, d, seg_len, weight,
               want_t: bool = False):
    """Hit test + bin index for every family with NO accumulation:
    ``{family: (idx [B, M] int32, w [B, M])}`` with ``w`` already masked
    by the hit (and = 1 per hit for the camera, which counts photons,
    detector_base.f90:229).  The chained DDA collects these per round and
    flushes once per megastep with :func:`flush_bins` instead of a
    scatter-add per round; these are pure elementwise ops.  With
    ``want_t`` each family also carries the hit distance ``t [B, M]``
    along the segment (for the pMC path-length-at-hit statistics)."""
    out = {}
    if bank.circle is not None:
        hit, val = bank.circle.check_hit(o, d, seg_len)
        row = [_bin_idx_1d(bank.circle, val),
               jnp.where(hit, weight[:, None], 0.0)]
        if want_t:
            _, t, _ = intersect_circle(bank.circle.dir, bank.circle.pos,
                                       bank.circle.radius,
                                       o[:, None, :], d[:, None, :])
            row.append(jnp.where(hit, t, 0.0))
        out["circle"] = tuple(row)
    if bank.annulus is not None:
        hit, val = bank.annulus.check_hit(o, d, seg_len)
        row = [_bin_idx_1d(bank.annulus, val),
               jnp.where(hit, weight[:, None], 0.0)]
        if want_t:
            _, t, _ = intersect_circle(bank.annulus.dir, bank.annulus.pos,
                                       bank.annulus.r2,
                                       o[:, None, :], d[:, None, :])
            row.append(jnp.where(hit, t, 0.0))
        out["annulus"] = tuple(row)
    if bank.fibre is not None:
        hit, val = bank.fibre.check_hit(o, d, seg_len)
        row = [_bin_idx_1d(bank.fibre, val),
               jnp.where(hit, weight[:, None], 0.0)]
        if want_t:
            lens_pos = (bank.fibre.pos
                        + bank.fibre.dir * bank.fibre.frontOffset[:, None])
            _, t, _ = intersect_circle(bank.fibre.dir, lens_pos,
                                       bank.fibre.f1Aperture,
                                       o[:, None, :], d[:, None, :])
            row.append(jnp.where(hit, t, 0.0))
        out["fibre"] = tuple(row)
    if bank.camera is not None:
        hit, (hx, hy) = bank.camera.check_hit(o, d, seg_len)
        row = [_bin_idx_cam(bank.camera, hx, hy),
               jnp.where(hit, 1.0, 0.0)]
        if want_t:
            denom_c = _dot(bank.camera.n, d[:, None, :])
            t = _dot(bank.camera.pos - o[:, None, :],
                     bank.camera.n) / jnp.where(denom_c != 0.0,
                                                denom_c, 1.0)
            row.append(jnp.where(hit, t, 0.0))
        out["camera"] = tuple(row)
    return out


def ordered_cols(bank: DetectorBank, fams, col: int):
    """Stack one column of :func:`check_bins` output into config order:
    ``[B, n_detectors]``."""
    cols = [fams[fam][col][:, m] for fam, m in bank.order]
    return jnp.stack(cols, axis=-1) if cols else None


def flush_bins(bank: DetectorBank, acc) -> DetectorBank:
    """Accumulate collected ``(idx, w)`` rounds into the bank bins with a
    dense one-hot reduction.  ``acc: {family: (idx [B', M], w [B', M])}``.
    Detector bin spaces are tiny (M x O(100) bins), so the dense
    weighted-one-hot sum is a bandwidth-bound reduction with no
    colliding writes."""
    import dataclasses as _dc

    def dense(data2d, idx, w):
        nb = data2d.shape[-1]
        oh = jax.nn.one_hot(idx, nb, dtype=w.dtype)  # [B', M, nb]
        return data2d + jnp.sum(w[..., None] * oh, axis=0)

    updates = {}
    for fam in ("circle", "annulus", "fibre", "camera"):
        f = getattr(bank, fam)
        if f is None or fam not in acc:
            continue
        idx, w = acc[fam]
        if fam == "camera":
            M, nb, _ = f.data.shape
            flat = dense(f.data.reshape(M, nb * nb), idx, w)
            updates[fam] = _dc.replace(f, data=flat.reshape(M, nb, nb))
        else:
            updates[fam] = _dc.replace(f, data=dense(f.data, idx, w))
    return _dc.replace(bank, **updates)


def record_hits(bank: DetectorBank, o, d, seg_len, weight,
                want_hit_matrix: bool = False):
    """Bin every segment against every detector, returning an updated bank
    (reference: record_hit_1D_sub / record_hit_2D_sub,
    detector_base.f90:137-163, :206-235).

    With ``want_hit_matrix`` also returns per-lane hit weights and hit
    distances ``[B, n_detectors]`` in config order (used by the
    escape-function kernel to attribute hits to source voxels and by the
    perturbation-MC gradient estimator)."""
    if bank is None:
        return (bank, None, None) if want_hit_matrix else bank
    circle = bank.circle
    annulus = bank.annulus
    fibre = bank.fibre
    camera = bank.camera
    fam_hits = {}
    fam_ts = {}

    def bin_1d(dect, hit, value):
        idx = _bin_idx_1d(dect, value)
        w = jnp.where(hit, weight[:, None], 0.0)
        data = dect.data  # [M, nbins+1]
        # scatter-add per member over the batch
        flat = idx + jnp.arange(data.shape[0])[None, :] * data.shape[1]
        add = jnp.zeros(data.size, data.dtype).at[flat.reshape(-1)].add(
            w.reshape(-1)
        )
        return data + add.reshape(data.shape)

    import dataclasses as _dc

    if circle is not None:
        hit, val = circle.check_hit(o, d, seg_len)
        fam_hits["circle"] = jnp.where(hit, weight[:, None], 0.0)
        _, t, _ = intersect_circle(circle.dir, circle.pos, circle.radius,
                                   o[:, None, :], d[:, None, :])
        fam_ts["circle"] = jnp.where(hit, t, 0.0)
        circle = _dc.replace(circle, data=bin_1d(circle, hit, val))
    if annulus is not None:
        hit, val = annulus.check_hit(o, d, seg_len)
        fam_hits["annulus"] = jnp.where(hit, weight[:, None], 0.0)
        _, t, _ = intersect_circle(annulus.dir, annulus.pos, annulus.r2,
                                   o[:, None, :], d[:, None, :])
        fam_ts["annulus"] = jnp.where(hit, t, 0.0)
        annulus = _dc.replace(annulus, data=bin_1d(annulus, hit, val))
    if fibre is not None:
        hit, val = fibre.check_hit(o, d, seg_len)
        fam_hits["fibre"] = jnp.where(hit, weight[:, None], 0.0)
        lens_pos = fibre.pos + fibre.dir * fibre.frontOffset[:, None]
        _, t, _ = intersect_circle(fibre.dir, lens_pos, fibre.f1Aperture,
                                   o[:, None, :], d[:, None, :])
        fam_ts["fibre"] = jnp.where(hit, t, 0.0)
        fibre = _dc.replace(fibre, data=bin_1d(fibre, hit, val))
    if camera is not None:
        hit, (hx, hy) = camera.check_hit(o, d, seg_len)
        data = camera.data  # [M, nb, nb]
        nb = data.shape[1]
        w = jnp.where(hit, 1.0, 0.0)  # camera adds 1, not weight
        fam_hits["camera"] = w
        denom_c = _dot(camera.n, d[:, None, :])
        t_cam = _dot(camera.pos - o[:, None, :], camera.n) / jnp.where(
            denom_c != 0.0, denom_c, 1.0
        )
        fam_ts["camera"] = jnp.where(hit, t_cam, 0.0)
        flat = (jnp.arange(data.shape[0])[None, :] * nb * nb
                + _bin_idx_cam(camera, hx, hy))
        add = jnp.zeros(data.size, data.dtype).at[flat.reshape(-1)].add(
            w.reshape(-1)
        )
        camera = _dc.replace(camera, data=data + add.reshape(data.shape))

    new_bank = DetectorBank(
        circle=circle, annulus=annulus, fibre=fibre, camera=camera,
        target_values=bank.target_values, order=bank.order, ids=bank.ids,
        layers=bank.layers,
    )
    if not want_hit_matrix:
        return new_bank
    cols = [fam_hits[fam][:, member] for fam, member in bank.order]
    tcols = [fam_ts[fam][:, member] for fam, member in bank.order]
    hitw = jnp.stack(cols, axis=-1) if cols else None
    hitt = jnp.stack(tcols, axis=-1) if tcols else None
    return new_bank, hitw, hitt


def totals(bank: DetectorBank) -> jnp.ndarray:
    """Per-detector total counts in user order (reference total_dect,
    detector_base.f90:175-203)."""
    per_family = {}
    if bank.circle is not None:
        per_family["circle"] = jnp.sum(bank.circle.data, axis=-1)
    if bank.annulus is not None:
        per_family["annulus"] = jnp.sum(bank.annulus.data, axis=-1)
    if bank.fibre is not None:
        per_family["fibre"] = jnp.sum(bank.fibre.data, axis=-1)
    if bank.camera is not None:
        per_family["camera"] = jnp.sum(bank.camera.data, axis=(-1, -2))
    out = []
    for fam, member in bank.order:
        out.append(per_family[fam][member])
    return jnp.stack(out) if out else jnp.zeros((0,))


def zero_detectors(bank: DetectorBank) -> DetectorBank:
    """Zero the accumulated bins only (reference zero_dect,
    detector_base.f90:165-173); geometry and targets are preserved."""
    if bank is None:
        return None
    import dataclasses as _dc

    def fam(f):
        if f is None:
            return None
        return _dc.replace(f, data=jnp.zeros_like(f.data))

    return _dc.replace(
        bank, circle=fam(bank.circle), annulus=fam(bank.annulus),
        fibre=fam(bank.fibre), camera=fam(bank.camera),
    )
