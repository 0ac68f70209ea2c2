"""Scene representation and batched SDF evaluation.

Vectorised redesign of the reference's polymorphic SDF containers
(reference: src/sdfs/sdf_base.f90).  Instead of an array of OO objects with
virtual ``evaluate`` methods, a scene here is:

- a *static* structural description (which primitive/modifier kinds, how they
  nest) captured in ``PrimSpec`` trees, and
- *dynamic* parameter pytrees (shape params, 4x4 transforms, optical
  properties) that are traced -- so the entire distance field compiles to one
  fused XLA program and every parameter is differentiable.

Primitives of identical structure are grouped and evaluated with ``vmap``
over their stacked parameters, so a scene of 500 capsules (vessels scene)
costs one vectorised kernel, not 500 virtual calls per photon step
(reference hot loop: src/inttau2.f90:62-68 evaluates each SDF scalarly).

Layer semantics match the reference: the photon's "layer" is the *index into
the SDF array* of the innermost surface containing it, computed as
``maxloc(ds, mask=ds<0)`` (reference: src/kernelsMod.f90:1952).  We use
0 = outside, i+1 = prim i.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..maths.transforms import apply_transform, identity
from ..optics.properties import OptProps
from . import primitives as sdp

# ---------------------------------------------------------------------------
# PrimSpec: user facing scene description (mirrors reference init functions)
# ---------------------------------------------------------------------------

_PRIM_PARAM_NAMES = {
    "sphere": ("radius",),
    "box": ("half_lengths",),
    "torus": ("oradius", "iradius"),
    "cylinder": ("a", "b", "radius"),
    "triprism": ("h1", "h2"),
    "segment": ("a", "b"),
    "capsule": ("a", "b", "r"),
    "cone": ("a", "b", "ra", "rb"),
    "egg": ("r1", "r2", "h"),
    "plane": ("a",),
}

_PRIM_FNS = {
    "sphere": sdp.sd_sphere,
    "box": sdp.sd_box,
    "torus": sdp.sd_torus,
    "cylinder": sdp.sd_cylinder,
    "triprism": sdp.sd_triprism,
    "segment": sdp.sd_segment,
    "capsule": sdp.sd_capsule,
    "cone": sdp.sd_cone,
    "egg": sdp.sd_egg,
    "plane": sdp.sd_plane,
}

_MODIFIERS = (
    "revolution",
    "extrude",
    "onion",
    "twist",
    "bend",
    "elongate",
    "displacement",
    "repeat",
)

_CSG_OPS = ("union", "smooth_union", "subtraction", "intersection")


class PrimSpec:
    """One node of a scene: a primitive, a modifier wrapping a child, or a
    CSG model combining children."""

    def __init__(
        self,
        kind: str,
        params: dict[str, Any],
        children: Sequence["PrimSpec"] = (),
        layer: int = 1,
        opt: Optional[OptProps] = None,
        op: Optional[str] = None,
        disp_func: Optional[Callable] = None,
    ):
        self.kind = kind
        self.params = dict(params)
        self.children = list(children)
        self.layer = layer
        self.opt = opt
        self.op = op
        self.disp_func = disp_func

    def signature(self):
        """Static structure key used to group identically shaped prims."""
        return (
            self.kind,
            self.op,
            self.disp_func,
            tuple(sorted(self.params.keys())),
            tuple(c.signature() for c in self.children),
        )

    # Specs are static parts of a Scene, so they key jit caches: compare
    # them by what a compiled program reads from them (the structure, and
    # whether the closed-form raycast applies), so that rebuilding the
    # same scene reuses its compiled programs.
    def _static_key(self):
        from .raycast import _is_analytic_spec

        return self.signature(), _is_analytic_spec(self)

    def __eq__(self, other):
        return (isinstance(other, PrimSpec)
                and self._static_key() == other._static_key())

    def __hash__(self):
        return hash(self._static_key())


def _as_arr(v, dtype):
    return jnp.asarray(v, dtype=dtype)


def _prim(kind, layer, opt, transform, dtype, **params) -> PrimSpec:
    t = identity(dtype) if transform is None else _as_arr(transform, dtype)
    p = {k: _as_arr(v, dtype) for k, v in params.items()}
    p["transform"] = t
    return PrimSpec(kind, p, layer=layer, opt=opt)


# -- constructor API mirroring the reference init functions ------------------

def sphere(radius, opt, layer, transform=None, dtype=jnp.float32):
    return _prim("sphere", layer, opt, transform, dtype, radius=radius)


def box(lengths, opt, layer, transform=None, dtype=jnp.float32):
    """``lengths`` are full extents; halved at init like the reference
    (src/sdfs/sdfs.f90:455)."""
    half = 0.5 * np.asarray(lengths, dtype=np.float64)
    return _prim("box", layer, opt, transform, dtype, half_lengths=half)


def torus(oradius, iradius, opt, layer, transform=None, dtype=jnp.float32):
    return _prim("torus", layer, opt, transform, dtype, oradius=oradius,
                 iradius=iradius)


def cylinder(a, b, radius, opt, layer, transform=None, dtype=jnp.float32):
    return _prim("cylinder", layer, opt, transform, dtype, a=a, b=b,
                 radius=radius)


def triprism(h1, h2, opt, layer, transform=None, dtype=jnp.float32):
    return _prim("triprism", layer, opt, transform, dtype, h1=h1, h2=h2)


def segment(a, b, opt, layer, transform=None, dtype=jnp.float32):
    return _prim("segment", layer, opt, transform, dtype, a=a, b=b)


def capsule(a, b, r, opt, layer, transform=None, dtype=jnp.float32):
    return _prim("capsule", layer, opt, transform, dtype, a=a, b=b, r=r)


def cone(a, b, ra, rb, opt, layer, transform=None, dtype=jnp.float32):
    return _prim("cone", layer, opt, transform, dtype, a=a, b=b, ra=ra, rb=rb)


def egg(r1, r2, h, opt, layer, transform=None, dtype=jnp.float32):
    return _prim("egg", layer, opt, transform, dtype, r1=r1, r2=r2, h=h)


def plane(a, opt, layer, transform=None, dtype=jnp.float32):
    return _prim("plane", layer, opt, transform, dtype, a=a)


# -- modifiers (reference: src/sdfs/sdfModifiers.f90) ------------------------

def _modifier(kind, child: PrimSpec, dtype=jnp.float32, **params) -> PrimSpec:
    p = {k: _as_arr(v, dtype) for k, v in params.items()}
    return PrimSpec(kind, p, children=[child], layer=child.layer,
                    opt=child.opt)


def revolution(child, o, center=(0.0, 0.0, 0.0), dtype=jnp.float32):
    return _modifier("revolution", child, dtype, o=o, center=center)


def extrude(child, h, dtype=jnp.float32):
    return _modifier("extrude", child, dtype, h=h)


def onion(child, thickness, dtype=jnp.float32):
    return _modifier("onion", child, dtype, thickness=thickness)


def twist(child, k, dtype=jnp.float32):
    return _modifier("twist", child, dtype, k=k)


def bend(child, k, dtype=jnp.float32):
    return _modifier("bend", child, dtype, k=k)


def elongate(child, size, dtype=jnp.float32):
    return _modifier("elongate", child, dtype, size=size)


def displacement(child, func: Callable, dtype=jnp.float32):
    spec = _modifier("displacement", child, dtype)
    spec.disp_func = func
    return spec


def repeat(child, c, la, lb, dtype=jnp.float32):
    """Finite repetition.  The reference declares but never implements this
    (error stop, src/sdfs/sdfModifiers.f90:410-426); we implement the
    standard Quilez finite-repeat formula."""
    return _modifier("repeat", child, dtype, c=c, la=la, lb=lb)


def model(children: Sequence[PrimSpec], op: str, k: float = 0.0,
          dtype=jnp.float32):
    """CSG model folding children with ``op``
    (reference: src/sdfs/sdf_base.f90:101-161)."""
    if op not in _CSG_OPS:
        raise ValueError(f"unknown CSG op {op!r}")
    spec = PrimSpec("model", {"k": _as_arr(k, dtype)},
                    children=list(children), layer=children[0].layer,
                    opt=children[0].opt, op=op)
    return spec


# ---------------------------------------------------------------------------
# CSG operator functions (reference: sdfModifiers.f90:428-492)
# ---------------------------------------------------------------------------

def op_union(d1, d2, k):
    return jnp.minimum(d1, d2)


def op_smooth_union(d1, d2, k):
    h = jnp.maximum(k - jnp.abs(d1 - d2), 0.0) / k
    return jnp.minimum(d1, d2) - h * h * h * k * (1.0 / 6.0)


def op_subtraction(d1, d2, k):
    return jnp.maximum(-d1, d2)


def op_intersection(d1, d2, k):
    return jnp.maximum(d1, d2)


_OP_FNS = {
    "union": op_union,
    "smooth_union": op_smooth_union,
    "subtraction": op_subtraction,
    "intersection": op_intersection,
}


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def eval_spec(spec: PrimSpec, params: dict, pos: jnp.ndarray) -> jnp.ndarray:
    """Evaluate one spec tree at ``pos [..., 3]`` with the given (possibly
    stacked-and-vmapped) parameter tree."""
    kind = spec.kind
    if kind in _PRIM_FNS:
        p = apply_transform(params["transform"], pos)
        args = {k: params[k] for k in _PRIM_PARAM_NAMES[kind]}
        return _PRIM_FNS[kind](p, **args)
    if kind == "revolution":
        # reference: sdfModifiers.f90:303-321
        p_in = pos - params["center"]
        pxz = jnp.sqrt(p_in[..., 0] ** 2 + p_in[..., 2] ** 2)
        q = jnp.stack(
            [pxz - params["o"], p_in[..., 1], jnp.zeros_like(pxz)], axis=-1
        )
        return eval_spec(spec.children[0], params["child0"], q)
    if kind == "extrude":
        # reference: sdfModifiers.f90:286-301
        d = eval_spec(spec.children[0], params["child0"], pos)
        wx = d
        wy = jnp.abs(pos[..., 2]) - params["h"]
        first = jnp.minimum(jnp.maximum(wx, wy), 0.0)
        second = jnp.sqrt(
            jnp.maximum(wx, 0.0) ** 2 + jnp.maximum(wy, 0.0) ** 2
        )
        return first + second
    if kind == "onion":
        d = eval_spec(spec.children[0], params["child0"], pos)
        return jnp.abs(d) - params["thickness"]
    if kind == "twist":
        # reference: sdfModifiers.f90:353-371
        c = jnp.cos(params["k"] * pos[..., 2])
        s = jnp.sin(params["k"] * pos[..., 2])
        q = jnp.stack(
            [
                c * pos[..., 0] - s * pos[..., 1],
                s * pos[..., 0] + c * pos[..., 1],
                pos[..., 2],
            ],
            axis=-1,
        )
        return eval_spec(spec.children[0], params["child0"], q)
    if kind == "bend":
        # reference: sdfModifiers.f90:373-391
        c = jnp.cos(params["k"] * pos[..., 0])
        s = jnp.sin(params["k"] * pos[..., 0])
        q = jnp.stack(
            [
                c * pos[..., 0] - s * pos[..., 1],
                s * pos[..., 0] + c * pos[..., 1],
                pos[..., 2],
            ],
            axis=-1,
        )
        return eval_spec(spec.children[0], params["child0"], q)
    if kind == "elongate":
        # reference: sdfModifiers.f90:335-351
        q = jnp.abs(pos) - params["size"]
        w = jnp.minimum(jnp.max(q, axis=-1), 0.0)
        return eval_spec(
            spec.children[0], params["child0"], jnp.maximum(q, 0.0)
        ) + w
    if kind == "displacement":
        d1 = eval_spec(spec.children[0], params["child0"], pos)
        d2 = spec.disp_func(pos)
        return d1 + d2
    if kind == "repeat":
        q = pos - params["c"] * jnp.clip(
            jnp.round(pos / params["c"]), params["la"], params["lb"]
        )
        return eval_spec(spec.children[0], params["child0"], q)
    if kind == "model":
        res = eval_spec(spec.children[0], params["child0"], pos)
        fn = _OP_FNS[spec.op]
        for i, ch in enumerate(spec.children[1:], start=1):
            res = fn(res, eval_spec(ch, params[f"child{i}"], pos),
                     params["k"])
        return res
    raise ValueError(f"unknown spec kind {spec.kind!r}")


def _collect_params(spec: PrimSpec) -> dict:
    out = dict(spec.params)
    for i, ch in enumerate(spec.children):
        out[f"child{i}"] = _collect_params(ch)
    return out


# ---------------------------------------------------------------------------
# Scene: grouped, stacked representation
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclass
class SceneTables:
    """Per-layer optical property table, index 0 = outside (sentinel).

    Monochromatic scenes: 1D arrays ``[N+1]``.  Spectral scenes: 2D arrays
    ``[W, N+1]`` binned over ``wavelengths [W]`` -- transport then looks
    properties up per photon wavelength, which the reference only
    half-implements (its spectral type exists but transport never
    resamples, src/opticalProps/piecewise.f90:13 note)."""

    mus: jnp.ndarray
    mua: jnp.ndarray
    hgg: jnp.ndarray
    n: jnp.ndarray
    wavelengths: object = None  # jnp [W] | None for monochromatic

    @property
    def kappa(self):
        return self.mus + self.mua

    @property
    def albedo(self):
        kappa = self.mus + self.mua
        safe = jnp.where(kappa > 0.0, kappa, 1.0)
        return jnp.where(self.mua < 1e-9, 1.0, self.mus / safe)

    @property
    def g2(self):
        return self.hgg * self.hgg


@jax.tree_util.register_dataclass
@dataclass
class Scene:
    """Grouped scene.  ``group_params[g]`` holds stacked parameter trees for
    all prims sharing structure ``specs[g]``; ``perm`` maps concatenated
    group columns back to the user's prim order."""

    group_params: list = field(metadata=dict(static=False))
    tables: SceneTables = field(metadata=dict(static=False))
    specs: tuple = field(metadata=dict(static=True))
    group_sizes: tuple = field(metadata=dict(static=True))
    perm: tuple = field(metadata=dict(static=True))
    layer_ids: tuple = field(metadata=dict(static=True))
    n_prims: int = field(metadata=dict(static=True))


def build_scene(prims: Sequence[PrimSpec], dtype=jnp.float32,
                n_wavelength_bins: int = 64) -> Scene:
    """Group prims by structural signature and stack their parameters.

    If any prim carries :class:`SpectralOptProps`, the optical table is
    built per wavelength bin over the union of the spectral table ranges
    and transport performs per-photon wavelength lookups."""
    groups: dict = {}
    order: list = []
    for i, pr in enumerate(prims):
        sig = pr.signature()
        if sig not in groups:
            groups[sig] = []
            order.append(sig)
        groups[sig].append(i)

    group_params = []
    specs = []
    group_sizes = []
    concat_order = []
    for sig in order:
        idxs = groups[sig]
        members = [_collect_params(prims[i]) for i in idxs]
        stacked = jax.tree_util.tree_map(
            lambda *xs: jnp.stack([jnp.asarray(x, dtype) for x in xs]),
            *members,
        )
        group_params.append(stacked)
        specs.append(prims[idxs[0]])
        group_sizes.append(len(idxs))
        concat_order.extend(idxs)

    # perm[user_index] = column position in the concatenated group output
    perm = [0] * len(prims)
    for col, user_idx in enumerate(concat_order):
        perm[user_idx] = col

    from ..optics.properties import SpectralOptProps

    spectral = any(isinstance(pr.opt, SpectralOptProps) for pr in prims)
    if not spectral:
        def opt_field(name, sentinel):
            vals = [sentinel] + [
                float(np.asarray(getattr(pr.opt, name))) for pr in prims
            ]
            return jnp.asarray(vals, dtype)

        tables = SceneTables(
            mus=opt_field("mus", 0.0),
            mua=opt_field("mua", 0.0),
            hgg=opt_field("hgg", 0.0),
            n=opt_field("n", 1.0),
        )
    else:
        # wavelength grid spanning all spectral tables
        los, his = [], []
        for pr in prims:
            if isinstance(pr.opt, SpectralOptProps):
                for tab in (pr.opt.mus_tab, pr.opt.mua_tab,
                            pr.opt.hgg_tab, pr.opt.n_tab):
                    los.append(float(tab.x[0]))
                    his.append(float(tab.x[-1]))
        wgrid = jnp.linspace(min(los), max(his), n_wavelength_bins,
                             dtype=dtype)

        def opt_field(name, sentinel):
            cols = [jnp.full_like(wgrid, sentinel)]
            for pr in prims:
                if isinstance(pr.opt, SpectralOptProps):
                    from ..optics.piecewise import sample_piecewise1d_at

                    tab = getattr(pr.opt, name + "_tab")
                    cols.append(sample_piecewise1d_at(tab, wgrid))
                else:
                    cols.append(
                        jnp.full_like(
                            wgrid,
                            float(np.asarray(getattr(pr.opt, name))),
                        )
                    )
            return jnp.stack(cols, axis=-1)  # [W, N+1]

        tables = SceneTables(
            mus=opt_field("mus", 0.0),
            mua=opt_field("mua", 0.0),
            hgg=opt_field("hgg", 0.0),
            n=opt_field("n", 1.0),
            wavelengths=wgrid,
        )

    return Scene(
        group_params=group_params,
        tables=tables,
        specs=tuple(specs),
        group_sizes=tuple(group_sizes),
        perm=tuple(perm),
        layer_ids=tuple(pr.layer for pr in prims),
        n_prims=len(prims),
    )


def eval_scene(scene: Scene, pos: jnp.ndarray) -> jnp.ndarray:
    """Distances to every prim: ``pos [..., 3] -> ds [..., N]`` in the
    user's prim order."""
    cols = []
    for spec, params, size in zip(scene.specs, scene.group_params,
                                  scene.group_sizes):
        if size == 1:
            single = jax.tree_util.tree_map(lambda a: a[0], params)
            d = eval_spec(spec, single, pos)[..., None]
        else:
            d = jax.vmap(
                lambda prm: eval_spec(spec, prm, pos), in_axes=0,
                out_axes=-1
            )(params)
        cols.append(d)
    ds = jnp.concatenate(cols, axis=-1)
    # static permutation as unrolled slices (they fuse with the SDF
    # evaluation; eval_scene runs once per chain round)
    if tuple(scene.perm) == tuple(range(scene.n_prims)):
        return ds
    return jnp.concatenate(
        [ds[..., p:p + 1] for p in scene.perm], axis=-1
    )


def scene_layer(ds: jnp.ndarray) -> jnp.ndarray:
    """Innermost containing prim: 1-based index of ``maxloc(ds, ds<0)``,
    0 when outside everything (reference: src/kernelsMod.f90:1952)."""
    neg = ds < 0.0
    masked = jnp.where(neg, ds, -jnp.inf)
    # int32 pin: under jax_enable_x64 argmax returns int64, which would
    # break the transport carry typing
    idx = jnp.argmax(masked, axis=-1).astype(jnp.int32) + 1
    any_inside = jnp.any(neg, axis=-1)
    return jnp.where(any_inside, idx, 0)


def calc_normals(scene: Scene, pos: jnp.ndarray, h: float) -> jnp.ndarray:
    """Tetrahedron finite-difference surface normals of *every* prim at
    ``pos [..., 3] -> n [..., N, 3]`` (reference:
    src/sdfs/sdf_base.f90:166-190).  The transport engine selects the prim
    whose boundary was crossed per lane."""
    offs = jnp.asarray(
        [[1.0, -1.0, -1.0], [-1.0, -1.0, 1.0], [-1.0, 1.0, -1.0],
         [1.0, 1.0, 1.0]],
        dtype=pos.dtype,
    )
    # [..., 4, 3] evaluation points
    pts = pos[..., None, :] + offs * h
    ds = eval_scene(scene, pts)  # [..., 4, N]
    # explicit sum instead of einsum: an f32 contraction at default
    # precision may run in TF32 on tensor cores, and differences of
    # rounded taps at offset h corrupt Fresnel normals
    n = sum(
        ds[..., k, :, None] * offs[k] for k in range(4)
    )  # [..., N, 3]
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    return n / jnp.where(norm > 0.0, norm, 1.0)
