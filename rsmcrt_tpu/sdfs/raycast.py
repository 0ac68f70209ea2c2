"""Analytic ray-surface intersection for the standard primitives.

Closed-form replacement for sphere-trace *creep*: the reference finds the next
surface by repeated conservative SDF steps (reference: src/inttau2.f90:155-192)
which converges linearly with factor ``1 - sin(theta)`` -- grazing rays need
hundreds of iterations, and rays that pass near a surface without crossing it
creep anyway.  For rigid-transformed primitives the first surface crossing
along a ray has a closed form, so the transport engine can jump the whole
segment in one step and land ``eps/2`` before the true crossing (or take the
full optical-depth step when the ray never crosses anything).

The physics is identical -- tracing is only a means of finding the next
surface along the ray (same role as the reference's analytic detector
intersectors, src/geometryMod.f90).

Primitives without a practical closed form (torus quartic, egg, triprism,
every modifier and CSG model) are *non-analytic*: the engine falls back to
capped sphere-trace marching for those, still bounded by the analytic
crossings of the other prims.

Assumes rigid transforms (rotation + translation), the same assumption the
SDF metric itself requires (distances are not preserved under scaling).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..maths.transforms import apply_rotation, apply_transform

_INF = jnp.inf

# prim kinds with closed-form ray crossings; everything else (modifiers
# other than revolution-of-egg, CSG models) falls back to sphere-trace
# marching
ANALYTIC_KINDS = ("sphere", "box", "plane", "cylinder", "capsule",
                  "segment", "cone", "torus", "triprism")


def _first_pos(*ts):
    """Elementwise smallest strictly-positive among candidates (inf if none).
    Invalid candidates must already be +inf."""
    out = None
    for t in ts:
        t = jnp.where(t > 0.0, t, _INF)
        out = t if out is None else jnp.minimum(out, t)
    return out


def ray_sphere(p, d, radius):
    """First crossing of ``|p + t d| = radius`` (both sides)."""
    b = jnp.sum(p * d, axis=-1)
    c = jnp.sum(p * p, axis=-1) - radius * radius
    disc = b * b - c
    sq = jnp.sqrt(jnp.maximum(disc, 1e-30))
    t1 = -b - sq
    t2 = -b + sq
    miss = disc < 0.0
    return jnp.where(miss, _INF, _first_pos(t1, t2))


def ray_box(p, d, half_lengths):
    """Slab method; first crossing of the box surface from either side."""
    safe_d = jnp.where(d == 0.0, 1.0, d)
    ta = (-half_lengths - p) / safe_d
    tb = (half_lengths - p) / safe_d
    # d == 0 on an axis: inside that slab -> (-inf, inf); outside -> empty
    inside_slab = jnp.abs(p) <= half_lengths
    lo = jnp.where(d == 0.0, jnp.where(inside_slab, -_INF, _INF),
                   jnp.minimum(ta, tb))
    hi = jnp.where(d == 0.0, jnp.where(inside_slab, _INF, -_INF),
                   jnp.maximum(ta, tb))
    tn = jnp.max(lo, axis=-1)
    tf = jnp.min(hi, axis=-1)
    miss = tn > tf
    return jnp.where(miss, _INF, _first_pos(tn, tf))


def ray_plane(p, d, a):
    """Crossing of the half-space boundary ``a . x = 0``."""
    dn = jnp.sum(d * a, axis=-1)
    s = jnp.sum(p * a, axis=-1)
    t = -s / jnp.where(dn == 0.0, 1.0, dn)
    return jnp.where(dn == 0.0, _INF, _first_pos(t))


def _axis_decomp(p, d, a, b):
    """Shared cylinder/capsule machinery: axial parameter u in [0, 1] and
    the radial quadratic coefficients."""
    ba = b - a
    m = p - a
    baba = jnp.sum(ba * ba, axis=-1)
    safe = jnp.where(baba == 0.0, 1.0, baba)
    u_m = jnp.sum(m * ba, axis=-1) / safe  # axial coord of ray origin
    u_d = jnp.sum(d * ba, axis=-1) / safe  # axial rate along ray
    mp = m - ba * u_m[..., None]
    dp = d - ba * u_d[..., None]
    A = jnp.sum(dp * dp, axis=-1)
    B = jnp.sum(mp * dp, axis=-1)
    return ba, m, baba, u_m, u_d, mp, dp, A, B


def _side_roots(A, B, C):
    disc = B * B - A * C
    safeA = jnp.where(A == 0.0, 1.0, A)
    sq = jnp.sqrt(jnp.maximum(disc, 1e-30))
    t1 = (-B - sq) / safeA
    t2 = (-B + sq) / safeA
    bad = jnp.logical_or(disc < 0.0, A == 0.0)
    t1 = jnp.where(bad, _INF, t1)
    t2 = jnp.where(bad, _INF, t2)
    # degenerate linear case (cone slant-parallel rays): A=0, B!=0
    lin = jnp.logical_and(A == 0.0, B != 0.0)
    t_lin = -C / jnp.where(B == 0.0, 1.0, 2.0 * B)
    return jnp.where(lin, t_lin, t1), t2


def ray_cylinder(p, d, a, b, radius):
    """Capped cylinder from ``a`` to ``b`` (reference sd_cylinder,
    src/sdfs/sdfs.f90:544)."""
    ba, m, baba, u_m, u_d, mp, dp, A, B = _axis_decomp(p, d, a, b)
    C = jnp.sum(mp * mp, axis=-1) - radius * radius
    t1, t2 = _side_roots(A, B, C)

    def side_ok(t):
        u = u_m + t * u_d
        return jnp.where(jnp.logical_and(u >= 0.0, u <= 1.0), t, _INF)

    def cap(u_target):
        safe = jnp.where(u_d == 0.0, 1.0, u_d)
        t = (u_target - u_m) / safe
        q = mp + dp * t[..., None]  # radial vector at the cap plane
        rr = jnp.sum(q * q, axis=-1)
        ok = jnp.logical_and(u_d != 0.0, rr <= radius * radius)
        return jnp.where(ok, t, _INF)

    return _first_pos(side_ok(t1), side_ok(t2), cap(0.0), cap(1.0))


def ray_capsule(p, d, a, b, r):
    """Capsule from ``a`` to ``b`` radius ``r`` (reference sd_capsule,
    src/sdfs/sdfs.f90:628)."""
    ba, m, baba, u_m, u_d, mp, dp, A, B = _axis_decomp(p, d, a, b)
    C = jnp.sum(mp * mp, axis=-1) - r * r
    t1, t2 = _side_roots(A, B, C)

    def side_ok(t):
        u = u_m + t * u_d
        return jnp.where(jnp.logical_and(u >= 0.0, u <= 1.0), t, _INF)

    def cap_sphere(center, beyond_hi):
        # BOTH sphere roots must be tested individually: a ray from inside
        # the capsule exiting axially has its first root inside the
        # cylindrical span (not capsule surface) and its true cap exit at
        # the second root
        pc = p - center
        bq = jnp.sum(pc * d, axis=-1)
        cq = jnp.sum(pc * pc, axis=-1) - r * r
        disc = bq * bq - cq
        sq = jnp.sqrt(jnp.maximum(disc, 1e-30))
        miss = disc < 0.0

        def ok(t):
            u = u_m + t * u_d
            on_cap = jnp.where(beyond_hi, u > 1.0, u < 0.0)
            return jnp.where(jnp.logical_or(miss,
                                            jnp.logical_not(on_cap)),
                             _INF, t)

        return ok(-bq - sq), ok(-bq + sq)

    ca1, ca2 = cap_sphere(a, False)
    cb1, cb2 = cap_sphere(b, True)
    return _first_pos(side_ok(t1), side_ok(t2), ca1, ca2, cb1, cb2)


def ray_cone(p, d, a, b, ra, rb):
    """Capped cone, radius ``ra`` at ``a`` linearly to ``rb`` at ``b``
    (reference sd_cone, src/sdfs/sdfs.f90:650).  Lateral sheet:
    ``|radial(t)| = ra + (rb-ra) u(t)`` -> a quadratic in t."""
    ba, m, baba, u_m, u_d, mp, dp, A, B = _axis_decomp(p, d, a, b)
    rba = rb - ra
    c0 = ra + rba * u_m
    c1 = rba * u_d
    qa = A - c1 * c1
    qb = B - c0 * c1
    qc = jnp.sum(mp * mp, axis=-1) - c0 * c0
    t1, t2 = _side_roots(qa, qb, qc)

    def side_ok(t):
        u = u_m + t * u_d
        ok = jnp.logical_and(
            jnp.logical_and(u >= 0.0, u <= 1.0),
            c0 + c1 * t >= 0.0,  # same nappe of the cone
        )
        return jnp.where(ok, t, _INF)

    def cap(u_target, radius):
        safe = jnp.where(u_d == 0.0, 1.0, u_d)
        t = (u_target - u_m) / safe
        q = mp + dp * t[..., None]
        rr = jnp.sum(q * q, axis=-1)
        ok = jnp.logical_and(u_d != 0.0, rr <= radius * radius)
        return jnp.where(ok, t, _INF)

    return _first_pos(side_ok(t1), side_ok(t2), cap(0.0, ra), cap(1.0, rb))


def _newton_polish(sd_fn, p, d, t, iters=2, scale=1.0):
    """Refine root candidates ``t`` of ``sd_fn(p + t d) = 0`` with Newton
    steps (jvp gives the directional derivative).  Invalid (inf) lanes pass
    through untouched; steps are clamped to stay near the seed so a polish
    can never jump to a different surface sheet.  ``scale`` is the prim's
    characteristic size: the clamp (and the caller's on-surface tol) grow
    with it so large prims don't discard real crossings whose f32 quartic
    roots carry proportionally larger error."""
    tf = jnp.where(jnp.isfinite(t), t, 0.0)
    clamp = 0.05 * scale
    for _ in range(iters):
        f, fp = jax.jvp(
            lambda s: sd_fn(p + s[..., None] * d), (tf,),
            (jnp.ones_like(tf),),
        )
        step = f / jnp.where(jnp.abs(fp) < 1e-8, jnp.sign(fp) * 1e-8 + 1e-12,
                             fp)
        tf = tf - jnp.clip(step, -clamp, clamp)
    return jnp.where(jnp.isfinite(t), tf, t)


def _validated_first(sd_fn, p, d, cands, tol=2e-3, t_min=1e-5,
                     iters=2, scale=1.0):
    """Newton-polish each candidate and keep the first strictly positive
    one that truly lies on the surface (|sd| < tol).  Quartic roots in f32
    carry O(1e-2) error; the polish converges quadratically on the real
    SDF, and validation discards spurious / wrong-branch roots.  A false
    positive only costs a wasted same-layer nudge in the engine (the probe
    re-evaluates the true field); missed crossings are what the loose tol
    guards against.  ``tol`` scales with the prim size (see
    _newton_polish)."""
    best = jnp.full(p.shape[:-1], _INF, p.dtype)
    tol = tol * scale
    for t in cands:
        t = _newton_polish(sd_fn, p, d, t, iters=iters, scale=scale)
        sd_at = sd_fn(p + t[..., None] * d)
        ok = jnp.logical_and(
            jnp.logical_and(jnp.isfinite(t), t > t_min),
            jnp.abs(sd_at) < tol,
        )
        best = jnp.minimum(best, jnp.where(ok, t, _INF))
    return best


def _solve_depressed_quartic(p, q, r):
    """Real roots of ``u^4 + p u^2 + q u + r = 0`` (Ferrari; resolvent
    cubic by the trigonometric method).  Returns 4 candidates, +inf where
    complex.  f32: callers MUST polish + validate the roots."""
    dtype = p.dtype
    inf = jnp.asarray(_INF, dtype)
    # resolvent cubic m^3 + a2 m^2 + a1 m + a0 = 0
    a2 = p
    a1 = 0.25 * p * p - r
    a0 = -0.125 * q * q
    Q = (3.0 * a1 - a2 * a2) / 9.0
    R = (9.0 * a2 * a1 - 27.0 * a0 - 2.0 * a2 ** 3) / 54.0
    disc = Q ** 3 + R * R
    # three-real-root branch: largest root via cos
    mQ = jnp.sqrt(jnp.maximum(-Q, 1e-30))
    cosarg = jnp.clip(R / jnp.maximum(mQ ** 3, 1e-30), -1.0, 1.0)
    theta = jnp.arccos(cosarg)
    m_tri = 2.0 * mQ * jnp.cos(theta / 3.0) - a2 / 3.0
    # one-real-root branch
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    S = jnp.cbrt(R + sq)
    T = jnp.cbrt(R - sq)
    m_one = S + T - a2 / 3.0
    m = jnp.where(disc <= 0.0, m_tri, m_one)
    # the resolvent has a root >= 0 whenever the quartic has real roots
    # (f(0) = -q^2/8 <= 0); clamp round-off
    m = jnp.maximum(m, 0.0)
    s = jnp.sqrt(jnp.maximum(2.0 * m, 0.0))
    biquad = s < 1e-6  # q ~ 0: u^4 + p u^2 + r = 0
    safe_s = jnp.where(biquad, 1.0, s)
    c1 = 0.5 * (p + 2.0 * m - q / safe_s)
    c2 = 0.5 * (p + 2.0 * m + q / safe_s)

    def quad_roots(b, c):
        # u^2 + b u + c = 0.  Double roots (degenerate torus = sphere
        # sheets) land at dq ~ -roundoff: keep slightly-negative
        # discriminants as tangent candidates -- the Newton polish +
        # on-surface validation keeps only real crossings
        dq = b * b - 4.0 * c
        tol = 1e-4 * (b * b + jnp.abs(c)) + 1e-6
        sdq = jnp.sqrt(jnp.maximum(dq, 1e-30))
        bad = dq < -tol
        return (jnp.where(bad, inf, 0.5 * (-b - sdq)),
                jnp.where(bad, inf, 0.5 * (-b + sdq)))

    f1a, f1b = quad_roots(s, c1)
    f2a, f2b = quad_roots(-s, c2)
    # biquadratic fallback: u^2 = (-p +- sqrt(p^2 - 4 r)) / 2
    dbq = p * p - 4.0 * r
    sbq = jnp.sqrt(jnp.maximum(dbq, 1e-30))
    u2a = 0.5 * (-p - sbq)
    u2b = 0.5 * (-p + sbq)

    def bq_pair(u2, ok):
        su = jnp.sqrt(jnp.maximum(u2, 1e-30))
        good = jnp.logical_and(ok, u2 >= 0.0)
        return (jnp.where(good, -su, inf), jnp.where(good, su, inf))

    b1a, b1b = bq_pair(u2a, dbq >= 0.0)
    b2a, b2b = bq_pair(u2b, dbq >= 0.0)
    roots = [
        jnp.where(biquad, ba, fa)
        for fa, ba in ((f1a, b1a), (f1b, b1b), (f2a, b2a), (f2b, b2b))
    ]
    return roots


def _torus_quartic_cands(p, d, R2, rad):
    """Root candidates of ``(sqrt(x^2+z^2) - R)^2 + y^2 = rad^2`` along
    ``p + t d`` where only R^2 enters (valid for negative major radii,
    e.g. the revolved-egg side sheet).  The ray origin is shifted to the
    closest approach to the centre so the quartic coefficients stay O(1)
    (f32 conditioning), making the cubic/quartic already depressed
    (o.d = 0)."""
    t0 = -jnp.sum(p * d, axis=-1)
    o = p + t0[..., None] * d
    m = jnp.sum(o * o, axis=-1)
    alpha = R2 - rad * rad
    axy = d[..., 0] ** 2 + d[..., 2] ** 2
    bxy = 2.0 * (o[..., 0] * d[..., 0] + o[..., 2] * d[..., 2])
    cxy = o[..., 0] ** 2 + o[..., 2] ** 2
    ma = m + alpha
    C = 2.0 * ma - 4.0 * R2 * axy
    D = -4.0 * R2 * bxy
    E = ma * ma - 4.0 * R2 * cxy
    roots = _solve_depressed_quartic(C, D, E)
    return [u + t0 for u in roots]


def ray_torus(p, d, oradius, iradius):
    """First crossing of the torus around the y axis (reference sd_torus,
    src/sdfs/sdfs.f90:527-542) -- quartic roots + Newton polish on the
    true SDF + on-surface validation."""
    from .primitives import sd_torus

    sd_fn = lambda q: sd_torus(q, oradius, iradius)
    scale = oradius + iradius  # characteristic size for tol/clamp/margin
    # bounding-sphere reject keeps the quartic well-conditioned
    t0 = -jnp.sum(p * d, axis=-1)
    o = p + t0[..., None] * d
    near = jnp.sum(o * o, axis=-1) <= (1.5 * scale) ** 2
    cands = _torus_quartic_cands(p, d, oradius * oradius, iradius)
    t = _validated_first(sd_fn, p, d, cands, scale=scale)
    return jnp.where(near, t, _INF)


def ray_triprism(p, d, h1, h2):
    """Triangular prism (reference sd_triPrism, src/sdfs/sdfs.f90:583-597):
    the zero level set is a convex polyhedron of 5 planes -- generalized
    slab method."""
    dtype = p.dtype
    inf = jnp.asarray(_INF, dtype)
    c866, c05 = 0.866025, 0.5
    # (normal, offset) with inside = n.x <= b
    planes = [
        ((0.0, 0.0, 1.0), h2),
        ((0.0, 0.0, -1.0), h2),
        ((0.0, -1.0, 0.0), 0.5 * h1),
        ((c866, c05, 0.0), 0.5 * h1),
        ((-c866, c05, 0.0), 0.5 * h1),
    ]
    lo = jnp.full(p.shape[:-1], -_INF, dtype)
    hi = jnp.full(p.shape[:-1], _INF, dtype)
    for n, b in planes:
        nv = jnp.asarray(n, dtype)
        s = jnp.sum(p * nv, axis=-1) - b  # > 0 outside this half-space
        dn = jnp.sum(d * nv, axis=-1)
        t = -s / jnp.where(dn == 0.0, 1.0, dn)
        para_in = jnp.logical_and(dn == 0.0, s <= 0.0)
        l_i = jnp.where(dn < 0.0, t,
                        jnp.where(dn > 0.0, -inf,
                                  jnp.where(para_in, -inf, inf)))
        h_i = jnp.where(dn > 0.0, t,
                        jnp.where(dn < 0.0, inf,
                                  jnp.where(para_in, inf, -inf)))
        lo = jnp.maximum(lo, l_i)
        hi = jnp.minimum(hi, h_i)
    miss = lo > hi
    return jnp.where(miss, inf, _first_pos(lo, hi))


def ray_egg_revolution(p, d, center, o, r1, r2, h):
    """Revolution of the Moss egg (the egg scene's shell/albumen,
    reference setupGeometry.f90:149-247 + sdfModifiers.f90:303-321).

    In the (rho, y) half-plane the egg boundary is three circular arcs
    (sdfs.f90:688-718), so the revolved surface consists of sphere /
    torus sheets:

    - bottom (y <= 0): circle radius r1 about the axis point -> torus
      with major radius ``o`` (sphere when o = 0),
    - top: circle about (0, h+r) -> torus major ``o``,
    - side: circle of radius r1+el about (-el, 0) -> torus sheet with
      major radius ``o - el`` (the quartic only sees its square, so the
      negative major radius at o=0 is fine).

    All sheet candidates are polished + validated against the true
    revolved SDF, which also applies the region selection."""
    from .primitives import sd_egg

    r = r1 - r2
    h_in = h + r
    el = (h_in ** 2 - r ** 2) / (2.0 * r)
    rtop = (r1 + el) - jnp.sqrt(h_in ** 2 + el ** 2)

    def sd_fn(q):
        qc = q - center
        rho = jnp.sqrt(qc[..., 0] ** 2 + qc[..., 2] ** 2)
        q2 = jnp.stack(
            [rho - o, qc[..., 1], jnp.zeros_like(rho)], axis=-1
        )
        return sd_egg(q2, r1, r2, h)

    pc = p - center
    # bottom / top sheets: at o=0 (every scene builder) the quartic
    # degenerates to a plain sphere whose roots are already exact --
    # one polish iteration suffices (halves the probe's jvp evals)
    cands_sph = []
    cands_sph += _torus_quartic_cands(pc, d, o * o, r1)
    shift = jnp.zeros_like(pc).at[..., 1].set(1.0) * h_in
    cands_sph += _torus_quartic_cands(pc - shift, d, o * o, rtop)
    # side sheet: torus(R=o-el, rad=r1+el)
    Rs = o - el
    cands_q = _torus_quartic_cands(pc, d, Rs * Rs, r1 + el)
    scale = r1 + jnp.abs(o)  # characteristic size for tol/clamp
    t_sph = _validated_first(sd_fn, p, d, cands_sph, iters=1, scale=scale)
    t_q = _validated_first(sd_fn, p, d, cands_q, iters=2, scale=scale)
    return jnp.minimum(t_sph, t_q)


def _ray_prim(spec, params, pos, dirn):
    kind = spec.kind
    if kind == "revolution":
        # modifiers carry no transform; analytic only for an egg child
        # (checked by _is_analytic_spec) whose own transform is identity
        # in every scene builder (setupGeometry.f90:149-247)
        ch = params["child0"]
        return ray_egg_revolution(pos, dirn, params["center"], params["o"],
                                  ch["r1"], ch["r2"], ch["h"])
    T = params["transform"]
    p = apply_transform(T, pos)
    d = apply_rotation(T, dirn)
    if kind == "sphere":
        return ray_sphere(p, d, params["radius"])
    if kind == "box":
        return ray_box(p, d, params["half_lengths"])
    if kind == "plane":
        return ray_plane(p, d, params["a"])
    if kind == "cylinder":
        return ray_cylinder(p, d, params["a"], params["b"], params["radius"])
    if kind == "capsule":
        return ray_capsule(p, d, params["a"], params["b"], params["r"])
    if kind == "segment":
        # fixed 0.1 thickness capsule (reference sdfs.f90:624)
        return ray_capsule(p, d, params["a"], params["b"],
                           jnp.asarray(0.1, pos.dtype))
    if kind == "cone":
        return ray_cone(p, d, params["a"], params["b"], params["ra"],
                        params["rb"])
    if kind == "torus":
        return ray_torus(p, d, params["oradius"], params["iradius"])
    if kind == "triprism":
        return ray_triprism(p, d, params["h1"], params["h2"])
    raise ValueError(f"no analytic raycast for {kind!r}")


def _is_analytic_spec(spec) -> bool:
    """Structural predicate: does this spec have a closed-form raycast?"""
    if spec.kind in ANALYTIC_KINDS:
        return True
    if (spec.kind == "revolution" and len(spec.children) == 1
            and spec.children[0].kind == "egg"):
        # ray_egg_revolution assumes the child egg sits at the origin:
        # only claim analytic when its transform is identity (true for
        # every built-in scene, setupGeometry.f90:149-247); a user egg
        # with a transform falls back to the marched probe instead of
        # silently raycasting the untransformed egg
        ct = spec.children[0].params.get("transform")
        if ct is None or np.allclose(np.asarray(ct), np.eye(4), atol=1e-7):
            return True
        return False
    return False


def analytic_column_mask(scene) -> tuple:
    """Static per-prim (user order) bool: has closed-form crossing."""
    mask = [False] * scene.n_prims
    col = 0
    for spec, size in zip(scene.specs, scene.group_sizes):
        ok = _is_analytic_spec(spec)
        for _ in range(size):
            mask[col] = ok
            col += 1
    # mask is in concatenated-group order; convert to user order via perm
    user = [False] * scene.n_prims
    for user_idx, c in enumerate(scene.perm):
        user[user_idx] = mask[c]
    return tuple(user)


def ray_bound(scene, pos, dirn):
    """Smallest positive crossing parameter over all *analytic* prims:
    ``pos [..., 3], dirn [..., 3] -> t [...]`` (+inf when none cross)."""
    best = None
    for spec, params, size in zip(scene.specs, scene.group_params,
                                  scene.group_sizes):
        if not _is_analytic_spec(spec):
            continue
        if size == 1:
            single = jax.tree_util.tree_map(lambda a: a[0], params)
            t = _ray_prim(spec, single, pos, dirn)
        else:
            ts = jax.vmap(
                lambda prm: _ray_prim(spec, prm, pos, dirn), in_axes=0,
                out_axes=-1,
            )(params)
            t = jnp.min(ts, axis=-1)
        best = t if best is None else jnp.minimum(best, t)
    if best is None:
        return jnp.full(pos.shape[:-1], _INF, pos.dtype)
    return best


def ray_bound_idx(scene, pos, dirn):
    """Like :func:`ray_bound` but also returns WHICH analytic prim owns the
    first crossing: ``(t [...], idx [...] int32)`` with ``idx`` in
    concatenated-group order (the order :func:`surface_normal` consumes).
    ``idx`` is 0 when nothing crosses (t = +inf)."""
    best = jnp.full(pos.shape[:-1], _INF, pos.dtype)
    bidx = jnp.zeros(pos.shape[:-1], jnp.int32)
    offset = 0
    for spec, params, size in zip(scene.specs, scene.group_params,
                                  scene.group_sizes):
        if not _is_analytic_spec(spec):
            offset += size
            continue
        if size == 1:
            single = jax.tree_util.tree_map(lambda a: a[0], params)
            t = _ray_prim(spec, single, pos, dirn)
            cand = jnp.full(pos.shape[:-1], offset, jnp.int32)
        else:
            ts = jax.vmap(
                lambda prm: _ray_prim(spec, prm, pos, dirn), in_axes=0,
                out_axes=-1,
            )(params)
            t = jnp.min(ts, axis=-1)
            cand = (offset + jnp.argmin(ts, axis=-1)).astype(jnp.int32)
        better = t < best
        best = jnp.where(better, t, best)
        bidx = jnp.where(better, cand, bidx)
        offset += size
    return best, bidx


def surface_normal(scene, pos, idx):
    """Unit surface normal of prim ``idx`` (concatenated-group order,
    from :func:`ray_bound_idx` / the marched probe) at world points
    ``pos [B, 3]`` -- the gradient of that prim's world-space SDF via
    ``jax.grad`` (exact where the reference uses a tetrahedron finite
    difference, src/sdfs/sdf_base.f90:166-190; sign conventions match
    since both are SDF gradients).  Covers EVERY spec kind -- modifiers
    and CSG models differentiate through :func:`eval_spec` -- so the
    chained walk can consume Fresnel events on marched surfaces too."""
    from .scene import eval_spec

    out = jnp.zeros_like(pos)
    offset = 0
    for spec, params, size in zip(scene.specs, scene.group_params,
                                  scene.group_sizes):
        def f(p, prm_single, spec=spec):
            return eval_spec(spec, prm_single, p)

        if size == 1:
            single = jax.tree_util.tree_map(lambda a: a[0], params)
            n = jax.vmap(jax.grad(f), in_axes=(0, None))(pos, single)
        else:
            member = jnp.clip(idx - offset, 0, size - 1)
            prm = jax.tree_util.tree_map(lambda a: a[member], params)
            n = jax.vmap(jax.grad(f))(pos, prm)
        # +1e-30: finite vjp at degenerate (zero-gradient) points
        norm = jnp.sqrt(jnp.sum(n * n, axis=-1, keepdims=True) + 1e-30)
        n = n / norm
        sel = jnp.logical_and(idx >= offset, idx < offset + size)
        out = jnp.where(sel[..., None], n, out)
        offset += size
    return out
