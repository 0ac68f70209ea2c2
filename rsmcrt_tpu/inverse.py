"""Inverse MCRT: recover optical properties from detector targets.

reference: ``inverse_MCRT`` (src/kernelsMod.f90:1462-1787) searches
(mus, mua, g, n) of one SDF layer to match per-detector ``targetValue``s by
pure random exploration; its AdaLIPO exploit branch is dead code (the
``ran <= 1.0`` guard is always true, :1667) and results are never written
(:1741).

This module provides both:

- :func:`inverse_random_search` -- a working version of the reference's
  random exploration (same bounds, error definition
  ``-mean |total/N - target|``, :1753-1787), which DOES track and return
  the best parameters;
- :func:`inverse_gradient_descent` -- the wavefront replacement: each
  forward run also accumulates per-detected-photon sufficient statistics
  (scatter count, path length, Henyey-Greenstein scores inside the target
  prim), giving closed-form perturbation-MC derivatives of every detector
  total with respect to (mus, mua, g):

      T(mus', mua') = Sum_gamma w_gamma (mus'/mus)^{s_gamma}
                      exp(-(mut' - mut) L_gamma)
      dT/dmus |_0 = Sum w (s/mus - L)
      dT/dmua |_0 = Sum w (-L)
      dT/dg   |_0 = Sum w * Sum_i d log p_HG(cos_i; g) / dg

  so Adam can descend the detector-error objective without
  differentiating through the discrete transport loop.
"""

from __future__ import annotations

from dataclasses import replace as dc_replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from .detectors.detectors import totals as detector_totals, zero_detectors
from .kernels import default_lanes, setup
from .optics.properties import mono
from .sdfs.scene import Scene
from .transport.engine import TransportConfig, simulate

# reference bounds (kernelsMod.f90:1609-1616)
BOUNDS = {
    "mus": (0.0, 100.0),
    "mua": (0.0, 100.0),
    "g": (-1.0, 1.0),
    "n": (1.0, 20.0),
}


def _prim_location(scene: Scene, layer_id: int):
    """Find the prim whose layer ID matches (reference:
    kernelsMod.f90:1583-1600) and its (group, member) slot."""
    try:
        prim_index = scene.layer_ids.index(layer_id)
    except ValueError:
        raise ValueError(
            "Selected layer not found in SDF array please choose a layer "
            "inside the SDF array"
        )
    return prim_index


def _set_prim_optics(scene: Scene, prim_index: int, mus, mua, hgg, n):
    """Return a scene with one prim's optical properties replaced
    (reference updateOptProp, sdf_base.f90:250-259).  The tables row
    ``prim_index + 1`` holds that prim's properties."""
    i = prim_index + 1
    t = scene.tables
    new_tables = dc_replace(
        t,
        mus=t.mus.at[i].set(mus),
        mua=t.mua.at[i].set(mua),
        hgg=t.hgg.at[i].set(hgg),
        n=t.n.at[i].set(n),
    )
    return dc_replace(scene, tables=new_tables)


def _prim_group_slot(scene: Scene, prim_index: int):
    """(group, member) slot of a prim in the stacked group parameters."""
    col = scene.perm[prim_index]
    acc = 0
    for g, size in enumerate(scene.group_sizes):
        if col < acc + size:
            return g, col - acc
        acc += size
    raise IndexError(prim_index)


def _set_prim_shape(scene: Scene, prim_index: int, name: str, value):
    """Return a scene with one prim's shape parameter (e.g. a sphere's
    ``radius``) replaced.  Geometry parameters are leaves of the stacked
    group pytree, so the whole transport remains a pure function of them
    -- the basis for SDF-shape recovery (which the reference cannot do at
    all, kernelsMod.f90:1553-1561 searches optical properties only)."""
    g, m = _prim_group_slot(scene, prim_index)
    params = scene.group_params[g]
    if name not in params:
        raise KeyError(
            f"prim {prim_index} has shape parameters {sorted(params)}, "
            f"not {name!r}"
        )
    new_params = list(scene.group_params)
    new_params[g] = {**params, name: params[name].at[m].set(value)}
    return dc_replace(scene, group_params=new_params)


def inverse_evaluate(totals, nphotons, target_values):
    """Error = -(1/M) Sum |total/N - target| over detectors with a target
    (reference: inverse_evaluate, kernelsMod.f90:1753-1787)."""
    totals = np.asarray(totals, np.float64)
    targets = np.asarray(target_values, np.float64)
    mask = targets != -1.0
    if not mask.any():
        return 0.0
    diffs = np.abs(totals[mask] / nphotons - targets[mask])
    return -float(diffs.mean())


def _forward(parsed, scene, cfg, seed, inverse_prim=0):
    bank = zero_detectors(parsed.detectors)
    tallies, bank_out, launched, _ = simulate(
        scene, parsed.source, parsed.settings.grid, jax.random.key(seed),
        cfg, bank=bank,
    )
    tot = np.asarray(detector_totals(bank_out))
    stats = np.asarray(tallies.pmc_stats) if inverse_prim else None
    return tot, stats, int(launched)


def inverse_random_search(input_file, nsteps=None, nphotons=None,
                          n_lanes=None, res_dir=None, verbose=True):
    """Random-exploration recovery (working version of the reference's
    explore loop, kernelsMod.f90:1663-1738)."""
    parsed, scene = setup(input_file, kernel="inverse", res_dir=res_dir)
    st = parsed.settings
    inv = st.inverse
    prim_index = _prim_location(scene, inv["layer"])

    find = [k for k, fk in (("mus", "Findmus"), ("mua", "Findmua"),
                            ("g", "Findg"), ("n", "Findn"))
            if inv[fk]]
    if not find:
        raise ValueError(
            "Please select at least one of mus, mua, hgg, n to find with "
            "inverse MCRT"
        )

    i = prim_index + 1
    current = {
        "mus": float(scene.tables.mus[i]),
        "mua": float(scene.tables.mua[i]),
        "g": float(scene.tables.hgg[i]),
        "n": float(scene.tables.n[i]),
    }
    nsteps = int(nsteps if nsteps is not None else inv["maxNumSteps"])
    nph = int(nphotons if nphotons is not None else st.nphotons)
    cfg = TransportConfig(
        nphotons=nph,
        n_lanes=int(n_lanes or default_lanes(nph)),
        record_fluence=False,  # the search scores detector totals only
    )

    rng = np.random.default_rng(st.iseed)
    history = []
    best = None
    for it in range(nsteps):
        trial = dict(current)
        for k in find:
            lo, hi = BOUNDS[k]
            trial[k] = float(rng.uniform(lo, hi))
        sc = _set_prim_optics(scene, prim_index, trial["mus"],
                              trial["mua"], trial["g"], trial["n"])
        tot, _, launched = _forward(parsed, sc, cfg, st.iseed + it)
        err = inverse_evaluate(tot, launched,
                               np.asarray(parsed.detectors.target_values))
        history.append({**trial, "error": err})
        if best is None or err > best["error"]:
            best = history[-1]
        if verbose:
            print(f"step {it}: error={err:.6f} best={best['error']:.6f}")
    return best, history


def _crn_fd_totals(parsed, scene_lo, scene_hi, cfg, seed, h):
    """Common-random-number central difference of the detector totals:
    both runs use the SAME RNG key, so the paths stay maximally
    correlated and the difference isolates the parameter effect.  Used
    for n and SDF-shape derivatives, where the parameter moves photons
    deterministically (Snell bending / boundary position) and the
    likelihood-ratio (pMC) score cannot capture the full derivative."""
    t_hi, _, n_hi = _forward(parsed, scene_hi, cfg, seed)
    t_lo, _, n_lo = _forward(parsed, scene_lo, cfg, seed)
    return (t_hi.astype(np.float64) / n_hi
            - t_lo.astype(np.float64) / n_lo) / (2.0 * h)


def inverse_gradient_descent(input_file, nsteps=50, nphotons=None,
                             chain=False,
                             n_lanes=None, lr=0.1, res_dir=None,
                             verbose=True, seed=None, shape_params=None,
                             h_n=2e-2, h_shape=2e-2, find=None,
                             lr_decay=10.0, n_method="score",
                             shape_method=None):
    """Gradient recovery of (mus, mua, g, n) plus optional SDF shape
    parameters -- the working, differentiable replacement for the
    reference's broken AdaLIPO loop.

    Every parameter class uses the perturbation-MC scores accumulated
    during the SINGLE forward run per step by default:

    - (mus, mua, g): closed-form likelihood-ratio scores;
    - n: Fresnel-choice score INCLUDING the angular reparameterization
      term carried by the propagated direction tangent
      (``LaneState.pmc_dd``) -- validated against the closed-form slab
      dT/dn to ~1e-3 at both 2 and 40 degrees incidence
      (tests/test_gradient_scores.py; reference estimand
      surfaces.f90:57-121);
    - shape ``radius``: boundary extinction score (kappa jump per
      surface crossing / reflection), exact when mus and n are
      continuous across the moved boundary.

    ``n_method="fd"`` / ``shape_method="fd"`` select the common-random-
    number central-difference fallback (two extra runs per parameter per
    step) for out-of-score-domain cases: n sitting exactly at a matched
    index (no Fresnel events -> zero score at a quadratic minimum),
    shape parameters other than a radius-like outward motion, or
    boundaries with mus/n contrast.  ``shape_method=None`` auto-selects:
    score for ``radius``, fd otherwise."""
    parsed, scene = setup(input_file, kernel="inverse", res_dir=res_dir)
    st = parsed.settings
    inv = st.inverse
    prim_index = _prim_location(scene, inv["layer"])
    targets = np.asarray(parsed.detectors.target_values, np.float64)

    if find is None:
        find = [k for k, fk in (("mus", "Findmus"), ("mua", "Findmua"),
                                ("g", "Findg")) if inv[fk]]
        find_n = bool(inv["Findn"])
    else:
        find_n = "n" in find
        find = [k for k in find if k in ("mus", "mua", "g")]
    shape_params = list(shape_params or [])

    i = prim_index + 1
    theta = {
        "mus": float(scene.tables.mus[i]),
        "mua": float(scene.tables.mua[i]),
        "g": float(scene.tables.hgg[i]),
        "n": float(scene.tables.n[i]),
    }
    g_slot, m_slot = _prim_group_slot(scene, prim_index)
    for sp in shape_params:
        theta[sp] = float(
            np.asarray(scene.group_params[g_slot][sp])[m_slot]
        )
    nph = int(nphotons if nphotons is not None else st.nphotons)
    cfg = TransportConfig(
        nphotons=nph,
        n_lanes=int(n_lanes or default_lanes(nph)),
        inverse_prim=prim_index + 1,
        # detector totals + pMC stats only: fluence deposits are the
        # single largest cost (the scatter-add) and play no role here.
        # chain=True additionally consumes events inside the walk (K per
        # lane per megastep)
        record_fluence=False,
        chain_scatter=chain,
    )

    def build_scene_at(th):
        sc = _set_prim_optics(scene, prim_index, th["mus"], th["mua"],
                              th["g"], th["n"])
        for sp in shape_params:
            sc = _set_prim_shape(sc, prim_index, sp, th[sp])
        return sc

    all_params = find + (["n"] if find_n else []) + shape_params
    # Adam state
    m = {k: 0.0 for k in all_params}
    v = {k: 0.0 for k in all_params}
    history = []
    base_seed = seed if seed is not None else st.iseed
    for it in range(nsteps):
        sc = build_scene_at(theta)
        tot, stats, launched = _forward(parsed, sc, cfg,
                                        base_seed + it,
                                        inverse_prim=prim_index + 1)
        # stats rows: [Sum w, Sum w*cnt, Sum w*len, Sum w*hg,
        #              Sum w*n_score, Sum w*R_score] per detector
        sw, swc, swl, swh, swn, swr = (stats[:, j].astype(np.float64)
                                       for j in range(6))
        err = inverse_evaluate(tot, launched, targets)
        mask = targets != -1.0
        sgn = np.sign(tot / launched - targets) * mask
        mcount = max(mask.sum(), 1)
        mus = max(theta["mus"], 1e-9)
        dT = {
            "mus": swc / mus - swl,
            "mua": -swl,
            "g": swh,
        }
        grads = {
            k: -float((sgn * dT[k]).sum() / launched / mcount)
            for k in find
        }
        if find_n:
            if n_method == "score":
                grads["n"] = -float((sgn * swn).sum() / launched / mcount)
            else:
                th_lo = {**theta, "n": theta["n"] - h_n}
                th_hi = {**theta, "n": theta["n"] + h_n}
                dTn = _crn_fd_totals(parsed, build_scene_at(th_lo),
                                     build_scene_at(th_hi), cfg,
                                     base_seed + it, h_n)
                grads["n"] = -float((sgn * dTn).sum() / mcount)
        for sp in shape_params:
            sm = shape_method or ("score" if sp == "radius" else "fd")
            if sm == "score":
                grads[sp] = -float(
                    (sgn * swr).sum() / launched / mcount)
            else:
                th_lo = {**theta, sp: theta[sp] - h_shape}
                th_hi = {**theta, sp: theta[sp] + h_shape}
                dTs = _crn_fd_totals(parsed, build_scene_at(th_lo),
                                     build_scene_at(th_hi), cfg,
                                     base_seed + it, h_shape)
                grads[sp] = -float((sgn * dTs).sum() / mcount)
        history.append({**theta, "error": err,
                        "grads": dict(grads)})
        if verbose:
            print(f"step {it}: err={err:.6f} "
                  + " ".join(f"{k}={theta[k]:.4f}" for k in all_params))
        # Adam ascent on err (maximise; err <= 0) with 1/(1+t/T) decay --
        # near the MC noise floor a constant step oscillates
        b1, b2, eps = 0.9, 0.999, 1e-8
        lr_t = lr / (1.0 + it / lr_decay)
        for k in all_params:
            gk = grads[k]
            m[k] = b1 * m[k] + (1 - b1) * gk
            v[k] = b2 * v[k] + (1 - b2) * gk * gk
            mh = m[k] / (1 - b1 ** (it + 1))
            vh = v[k] / (1 - b2 ** (it + 1))
            theta[k] = theta[k] + lr_t * mh / (np.sqrt(vh) + eps)
            if k in BOUNDS:
                lo, hi = BOUNDS[k]
                theta[k] = float(np.clip(theta[k], lo, hi))
            else:
                theta[k] = float(max(theta[k], 1e-3))  # shape > 0
    best = max(history, key=lambda h: h["error"])
    return {k: best[k] for k in theta}, history


def detector_gradients(input_file, nphotons=None, n_lanes=None,
                       res_dir=None, seed=None, h_n=2e-2, h_shape=2e-2,
                       shape_param=None, want_n=False, chain=False,
                       n_method="score", shape_method=None):
    """Per-detector totals and their gradients at the current scene
    parameters.  All five classes (mus, mua, g, n, radius-like shape)
    come from the pMC scores of the single forward run by default; pass
    ``n_method="fd"`` / ``shape_method="fd"`` for the CRN central-
    difference fallback (out-of-score-domain cases, see
    inverse_gradient_descent).  Used for finite-difference validation
    (BASELINE.md gradients row)."""
    parsed, scene = setup(input_file, kernel="inverse", res_dir=res_dir)
    st = parsed.settings
    inv = st.inverse
    prim_index = _prim_location(scene, inv["layer"])
    nph = int(nphotons if nphotons is not None else st.nphotons)
    cfg = TransportConfig(
        nphotons=nph,
        n_lanes=int(n_lanes or default_lanes(nph)),
        inverse_prim=prim_index + 1,
        record_fluence=False,  # detector totals + pMC stats only
        chain_scatter=chain,
    )
    base_seed = seed if seed is not None else st.iseed
    tot, stats, launched = _forward(
        parsed, scene, cfg, base_seed, inverse_prim=prim_index + 1,
    )
    i = prim_index + 1
    mus = float(scene.tables.mus[i])
    sw, swc, swl, swh, swn, swr = (stats[:, j].astype(np.float64)
                                   for j in range(6))
    out = dict(
        totals=tot,
        launched=launched,
        dT_dmus=swc / max(mus, 1e-9) - swl,
        dT_dmua=-swl,
        dT_dg=swh,
        parsed=parsed,
        scene=scene,
        prim_index=prim_index,
        cfg=cfg,
    )
    if want_n:
        if n_method == "score":
            out["dT_dn"] = swn
        else:
            n0 = float(scene.tables.n[i])
            mua0 = float(scene.tables.mua[i])
            g0 = float(scene.tables.hgg[i])
            sc_lo = _set_prim_optics(scene, prim_index, mus, mua0, g0,
                                     n0 - h_n)
            sc_hi = _set_prim_optics(scene, prim_index, mus, mua0, g0,
                                     n0 + h_n)
            out["dT_dn"] = _crn_fd_totals(parsed, sc_lo, sc_hi, cfg,
                                          base_seed, h_n) * launched
    if shape_param is not None:
        sm = shape_method or ("score" if shape_param == "radius"
                              else "fd")
        if sm == "score":
            out[f"dT_d{shape_param}"] = swr
        else:
            g_slot, m_slot = _prim_group_slot(scene, prim_index)
            s0 = float(np.asarray(scene.group_params[g_slot][shape_param])
                       [m_slot])
            sc_lo = _set_prim_shape(scene, prim_index, shape_param,
                                    s0 - h_shape)
            sc_hi = _set_prim_shape(scene, prim_index, shape_param,
                                    s0 + h_shape)
            out[f"dT_d{shape_param}"] = _crn_fd_totals(
                parsed, sc_lo, sc_hi, cfg, base_seed, h_shape
            ) * launched
    return out


def inverse_MCRT(input_file, data_dir="data", n_lanes=None, res_dir=None,
                 method="gradient", verbose=True):
    """Top-level inverse kernel (reference: kernelsMod.f90:1462-1751).
    Unlike the reference, results ARE written (its TODO at :1741)."""
    if method == "gradient":
        best, history = inverse_gradient_descent(
            input_file, n_lanes=n_lanes, res_dir=res_dir, verbose=verbose
        )
    else:
        best, history = inverse_random_search(
            input_file, n_lanes=n_lanes, res_dir=res_dir, verbose=verbose
        )
    out = Path(data_dir)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "inverse_results.dat", "w") as fh:
        fh.write("# step mus mua g n error\n")
        for it, h in enumerate(history):
            fh.write(
                f"{it} {h['mus']} {h['mua']} {h['g']} {h['n']} "
                f"{h['error']}\n"
            )
    return best, history
