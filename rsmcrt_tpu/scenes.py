"""Prebuilt experiment scenes.

Port of the reference scene library
(reference: src/setupGeometry.f90) plus the registry that dispatches on the
config's ``geom_name`` (reference: src/setup.f90:33-60).

Each builder returns a list of :class:`PrimSpec`; callers pass it to
``build_scene``.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from .maths import transforms as T
from .optics.properties import mono
from .sdfs import scene as S


def setup_sphere(params: dict):
    """Sphere in a vacuum bounding box (reference: setupGeometry.f90:10-71)."""
    mus = params["mus"]
    mua = params["mua"]
    hgg = params["hgg"]
    n = params["n"]
    pos = jnp.asarray(params.get("position", [0.0, 0.0, 0.0]), jnp.float32)
    bounding = params.get("boundinglength", [2.0, 2.0, 2.0])
    radius = params.get("sphereRadius", 1.0)
    t = T.invert(T.translate(pos))
    return [
        S.sphere(radius, mono(mus[0], mua[0], hgg[0], n[0]), 1, transform=t),
        S.box(bounding, mono(0.0, 0.0, 0.0, 1.0), 2),
    ]


def setup_box(params: dict):
    """Box in a vacuum bounding box (reference: setupGeometry.f90:73-147)."""
    mus, mua, hgg, n = (params[k] for k in ("mus", "mua", "hgg", "n"))
    pos = jnp.asarray(params.get("position", [0.0, 0.0, 0.0]), jnp.float32)
    bounding = params.get("boundinglength", [2.0, 2.0, 2.0])
    dims = params.get("BoxDimensions", [1.0, 1.0, 1.0])
    t = T.invert(T.translate(pos))
    return [
        S.box(dims, mono(mus[0], mua[0], hgg[0], n[0]), 1, transform=t),
        S.box(bounding, mono(0.0, 0.0, 0.0, 1.0), 2),
    ]


def setup_egg(params: dict):
    """Egg with yolk, albumen and shell
    (reference: setupGeometry.f90:149-248): shell and albumen are
    revolutions of egg SDFs, the yolk a sphere."""
    mus, mua, hgg, n = (params[k] for k in ("mus", "mua", "hgg", "n"))
    pos = jnp.asarray(params.get("position", [0.0, 0.0, 0.0]), jnp.float32)
    bounding = params.get("boundinglength", [2.0, 2.0, 2.0])
    r_bot = params.get("BottomSphereRadius", 3.0)
    r_top = params.get("TopSphereRadius", 3.0 * np.sqrt(2.0 - np.sqrt(2.0)))
    sep = params.get("SphereSep", 3.0 * np.sqrt(2.0 - np.sqrt(2.0)))
    thick = params.get("ShellThickness", 0.05)
    yolk_r = params.get("YolkRadius", 1.5)
    t = T.invert(T.translate(pos))

    shell = S.revolution(
        S.egg(r_bot, r_top, sep, mono(mus[0], mua[0], hgg[0], n[0]), 2),
        0.0, center=pos,
    )
    albumen = S.revolution(
        S.egg(
            r_bot * (1 - thick), r_top * (1 - thick), sep * (1 - thick),
            mono(mus[1], mua[1], hgg[1], n[1]), 3,
        ),
        0.0, center=pos,
    )
    yolk = S.sphere(yolk_r, mono(mus[2], mua[2], hgg[2], n[2]), 1,
                    transform=t)
    bbox = S.box(bounding, mono(0.0, 0.0, 0.0, 1.0), 4)
    return [yolk, albumen, shell, bbox]


def setup_sphere_scene(params: dict, rng: np.random.Generator | None = None):
    """N random spheres (reference: setupGeometry.f90:250-294)."""
    num = int(params.get("num_spheres", 10))
    rng = rng or np.random.default_rng(1234)
    opt_s = mono(0.0, 0.0, 0.9, 1.37)
    opt_b = mono(1e-17, 1e-17, 0.0, 1.0)
    prims = []
    for i in range(num):
        radius = rng.uniform(0.001, 0.25)
        centre = rng.uniform(-1.0 + radius, 1.0 - radius, 3)
        t = T.invert(T.translate(jnp.asarray(centre, jnp.float32)))
        prims.append(S.sphere(radius, opt_s, i + 1, transform=t))
    prims.append(S.box([2.0, 2.0, 2.0], opt_b, num + 1))
    return prims


def setup_tran_and_jacques():
    """Tran & Jacques n=1.33 sphere validation scene
    (reference: setupGeometry.f90:335-363)."""
    opt1 = mono(0.0, 1e-17, 0.0, 1.0)
    opt2 = mono(0.0, 10000000.0, 0.0, 1.0)
    opt3 = mono(0.0, 1e-17, 0.0, 1.33)
    t = T.invert(T.translate(jnp.zeros(3, jnp.float32)))
    return [
        S.sphere(0.5, opt3, 1, transform=t),
        S.box([2.0, 2.0, 2.0], opt1, 2),
        S.box([2.01, 2.01, 2.01], opt2, 3),
    ]


def setup_exp(params: dict):
    """Glass bottle with contents (reference: setupGeometry.f90:365-407)."""
    musb = params.get("musb", 0.0)
    muab = params.get("muab", 0.01)
    musc = params.get("musc", 0.0)
    muac = params.get("muac", 0.01)
    hgg = params.get("hgga", 0.7)
    a = [-8.0, 0.0, 0.0]
    b = [8.0, 0.0, 0.0]
    return [
        S.cylinder(a, b, 1.55, mono(musc, muac, hgg, 1.3), 1),
        S.cylinder(a, b, 1.75, mono(musb, muab, hgg, 1.5), 2),
        S.box([20.0, 20.0, 20.0], mono(0.0, 0.0, 0.0, 1.0), 2),
    ]


def setup_lens(params: dict):
    """Biconvex glass lens in vacuum -- an ORIGINAL scene.

    The reference ships res/lens.toml but has no "lens" case in its
    registry (setup.f90:33-60 would ``error stop``); here the config is
    runnable: a biconvex lens as the CSG intersection of two spheres
    (model machinery, reference sdfModifiers.f90:477), focusing the
    uniform beam of lens.toml.
    """
    n_glass = float(params.get("lensN", 1.52))
    r_curv = float(params.get("lensRadius", 0.9))
    half_thick = float(params.get("lensThickness", 0.25)) / 2.0
    opt_glass = mono(0.0, 1e-8, 0.0, n_glass)
    c = r_curv - half_thick  # sphere centre offset for the cap overlap
    s1 = S.sphere(r_curv, opt_glass, 1,
                  transform=T.invert(T.translate(
                      jnp.asarray([0.0, 0.0, -c], jnp.float32))))
    s2 = S.sphere(r_curv, opt_glass, 1,
                  transform=T.invert(T.translate(
                      jnp.asarray([0.0, 0.0, c], jnp.float32))))
    lens = S.model([s1, s2], "intersection")
    bbox = S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2)
    return [lens, bbox]


def setup_scat_test(params: dict):
    """tau-sphere scattering test (reference: setupGeometry.f90:409-435)."""
    tau = params.get("tau", 10.0)
    return [
        S.sphere(1.0, mono(tau, 0.0, 0.0, 1.0), 1),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2),
    ]


def setup_scat_test2(params: dict):
    """Near-infinite box scattering test
    (reference: setupGeometry.f90:437-464)."""
    tau = params.get("tau", 10.0)
    hgg = params.get("hgg", [0.9])[0]
    return [
        S.box([200.0, 200.0, 200.0], mono(tau, 1e-17, hgg, 1.0), 2),
    ]


def setup_omg_sdf():
    """The OMG lettering scene: cylinders + torus smooth-unioned
    (reference: setupGeometry.f90:466-549)."""
    opt1 = mono(10.0, 0.16, 0.0, 2.65)
    opt2 = mono(0.0, 0.0, 0.0, 1.0)
    layer = 1
    parts = []
    # O
    t = T.invert(T.translate(jnp.asarray([0.0, 0.0, -0.7], jnp.float32)))
    parts.append(S.torus(0.2, 0.05, opt1, layer, transform=t))
    # M
    t = T.invert(T.rotate_y(90.0))
    parts.append(
        S.cylinder([-0.25, 0.0, -0.25], [-0.25, 0.0, 0.25], 0.05, opt1,
                   layer, transform=t)
    )
    for a, b in [
        ([-0.25, 0.0, -0.25], [0.25, 0.0, 0.0]),
        ([0.25, 0.0, 0.0], [-0.25, 0.0, 0.25]),
        ([-0.25, 0.0, 0.25], [0.25, 0.0, 0.25]),
        # G
        ([-0.25, 0.0, 0.5], [0.25, 0.0, 0.5]),
        ([-0.25, 0.0, 0.5], [-0.25, 0.0, 0.75]),
        ([0.25, 0.0, 0.5], [0.25, 0.0, 0.75]),
        ([0.25, 0.0, 0.75], [0.0, 0.0, 0.75]),
        ([0.0, 0.0, 0.625], [0.0, 0.0, 0.75]),
    ]:
        parts.append(S.cylinder(a, b, 0.05, opt1, layer))
    return [
        S.model(parts, "smooth_union", 0.09),
        S.box([2.0, 2.0, 2.0], opt2, 2),
    ]


def get_vessels(res_dir: str | Path = "res"):
    """Blood vessel scene from nodes/edges/radii files
    (reference: setupGeometry.f90:552-652).  Optical properties from
    MCmatlab."""
    res_dir = Path(res_dir)
    nodes = np.loadtxt(res_dir / "nodes.dat")
    edges = np.loadtxt(res_dir / "edges.dat", dtype=int)
    radii = np.loadtxt(res_dir / "radii.dat")

    opt_vessel = mono(94.0, 231.0, 0.9, 1.37)
    opt_derm = mono(357.0, 0.458, 0.9, 1.37)

    res = 0.001  # 0.01 mm
    maxs = np.max(np.abs(nodes), axis=0)
    nodes = (nodes / maxs - 0.5) * maxs * res

    prims = []
    for i, (e0, e1) in enumerate(edges):
        a = nodes[e0 - 1]
        b = nodes[e1 - 1]
        radius = radii[e0 - 1] * res
        prims.append(S.capsule(a, b, radius, opt_vessel, 1))
    prims.append(S.box([0.32, 0.18, 0.26], opt_derm, 2))
    return prims


_SVG_NUM = re.compile(r"[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?")


def _parse_svg_segments(svg_file: Path):
    """Extract straight-line segments from SVG path elements.  Minimal
    self-contained replacement for the reference's offline svg_convert.py
    codegen (which writes res/svg.f90; the reference errors out if it is
    missing, setupGeometry.f90:326-329)."""
    tree = ET.parse(svg_file)
    segments = []
    for el in tree.iter():
        if not el.tag.endswith("path"):
            continue
        d = el.attrib.get("d", "")
        tokens = re.findall(r"[MmLlHhVvZz]|" + _SVG_NUM.pattern, d)
        pos = np.zeros(2)
        start = np.zeros(2)
        cmd = None
        i = 0
        while i < len(tokens):
            tok = tokens[i]
            if tok in "MmLlHhVvZz":
                cmd = tok
                i += 1
                if cmd in "Zz":
                    # close the subpath with an explicit segment
                    if not np.allclose(pos, start):
                        segments.append((pos.copy(), start.copy()))
                    pos = start.copy()
                continue
            if cmd in ("M", "m"):
                xy = np.array([float(tokens[i]), float(tokens[i + 1])])
                pos = xy if cmd == "M" else pos + xy
                start = pos.copy()
                i += 2
                cmd = "L" if cmd == "M" else "l"
                continue
            if cmd in ("L", "l"):
                xy = np.array([float(tokens[i]), float(tokens[i + 1])])
                new = xy if cmd == "L" else pos + xy
                segments.append((pos.copy(), new.copy()))
                pos = new
                i += 2
                continue
            if cmd in ("H", "h"):
                x = float(tokens[i])
                new = np.array([x if cmd == "H" else pos[0] + x, pos[1]])
                segments.append((pos.copy(), new.copy()))
                pos = new
                i += 1
                continue
            if cmd in ("V", "v"):
                y = float(tokens[i])
                new = np.array([pos[0], y if cmd == "V" else pos[1] + y])
                segments.append((pos.copy(), new.copy()))
                pos = new
                i += 1
                continue
            i += 1  # unsupported command args (curves) skipped
    return segments


def setup_logo(svg_file: str | Path = "res/logo.svg"):
    """Logo scene: SVG line segments extruded into SDF slabs
    (reference: setupGeometry.f90:297-332, which hard-requires a
    generated include from res/svg_convert.py and error-stops without
    it).  When fed the reference's crest the reference's normalisation
    constants are used (maxx/maxy 299.155.., 368.920.., minx/miny
    194.751.., 197.113.. from res/svg_convert.py); any other SVG is
    auto-normalised from its own segment bounding box, so the shipped
    original ``res/logo.svg`` runs from a fresh checkout."""
    svg_file = Path(svg_file)
    segments = _parse_svg_segments(svg_file)
    if not segments:
        raise ValueError(f"no line segments found in {svg_file}")
    if svg_file.name == "crest-simple.svg":
        maxx, maxy = 299.15545999999995, 368.92027
        minx, miny = 194.75158, 197.11304
    else:
        pts = np.asarray([p for seg in segments for p in seg])
        minx, miny = pts.min(axis=0)
        maxx, maxy = pts.max(axis=0) - np.array([minx, miny])
    eps = 1e-5

    opt_seg = mono(10.0, 0.1, 0.9, 1.5)
    opt_box = mono(0.0, 0.0, 0.0, 1.0)
    prims = []
    for p0, p1 in segments:
        x1 = (p0[0] - minx) / maxx - 0.5
        x2 = (p1[0] - minx) / maxx - 0.5
        y1 = (p0[1] - miny) / maxy - 0.5
        y2 = (p1[1] - miny) / maxy - 0.5
        if x1 == x2:
            x1 += eps
        if y1 == y2:
            y1 += eps
        seg = S.segment([x1, y1, 0.0], [x2, y2, 0.0], opt_seg, 1)
        prims.append(S.extrude(seg, 0.5))
    prims.append(S.box([10.0, 10.0, 2.001], opt_box, 2))
    return prims


def setup_simulation(geom_name: str, params: dict, res_dir="res"):
    """Scene registry (reference: src/setup.f90:33-60)."""
    if geom_name == "logo":
        # the reference's crest when present, else the shipped original
        crest = Path(res_dir) / "crest-simple.svg"
        return setup_logo(crest if crest.exists()
                          else Path(res_dir) / "logo.svg")
    if geom_name == "omg":
        return setup_omg_sdf()
    if geom_name == "scat_test":
        return setup_scat_test(params)
    if geom_name == "scat_test2":
        return setup_scat_test2(params)
    if geom_name == "aptran":
        return setup_tran_and_jacques()
    if geom_name == "vessels":
        return get_vessels(res_dir)
    if geom_name == "sphere_scene":
        return setup_sphere_scene(params)
    if geom_name in ("box", "test_box"):
        return setup_box(params)
    if geom_name == "sphere":
        return setup_sphere(params)
    if geom_name == "egg":
        return setup_egg(params)
    if geom_name == "exp":
        return setup_exp(params)
    if geom_name == "lens":
        return setup_lens(params)
    raise ValueError(f"no such routine: {geom_name}")
