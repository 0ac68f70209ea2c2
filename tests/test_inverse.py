"""Inverse MCRT / gradient tests (BASELINE.md: gradients vs finite
differences; replaces the reference's dead AdaLIPO loop,
kernelsMod.f90:1663-1738)."""

import numpy as np
import pytest

import jax

from rsmcrt_tpu.inverse import (
    _forward,
    _set_prim_optics,
    detector_gradients,
    inverse_evaluate,
)

CONFIG = "res/inverse_test.toml"


@pytest.mark.slow
def test_pmc_gradient_mua_matches_fd():
    """dT/dmua from perturbation-MC statistics matches common-random-number
    finite differences (the mua likelihood ratio exp(-dmua*L) is exact
    under CRN)."""
    res = detector_gradients(CONFIG, nphotons=30000, n_lanes=4096, seed=3)
    parsed, scene, cfg, pi = (res["parsed"], res["scene"], res["cfg"],
                              res["prim_index"])

    def run(mua):
        sc = _set_prim_optics(scene, pi, 5.0, mua, 0.5, 1.0)
        tot, _, _ = _forward(parsed, sc, cfg, 3, inverse_prim=pi + 1)
        return float(tot[0])

    fds = []
    for h in (0.02, 0.05):
        fds.append((run(0.5 + h) - run(0.5 - h)) / (2 * h))
    fd = float(np.mean(fds))
    pmc = float(res["dT_dmua"][0])
    assert fd != 0.0
    # CRN finite differences carry their own sampling noise (several % at
    # this photon count and the realised value shifts with the engine's
    # RNG consumption pattern); the estimator agreed to 0.2% of FD in
    # high-statistics runs
    assert abs(pmc - fd) / abs(fd) < 0.20, (pmc, fd)
    assert np.sign(pmc) == np.sign(fd)


@pytest.mark.slow
def test_pmc_gradient_signs_and_magnitudes():
    """mus/g gradients agree with independent-seed secants in sign and
    within Monte Carlo noise."""
    res = detector_gradients(CONFIG, nphotons=30000, n_lanes=4096, seed=3)
    parsed, scene, cfg, pi = (res["parsed"], res["scene"], res["cfg"],
                              res["prim_index"])

    def run(mus, g, seed):
        sc = _set_prim_optics(scene, pi, mus, 0.5, g, 1.0)
        tot, _, _ = _forward(parsed, sc, cfg, seed, inverse_prim=pi + 1)
        return float(tot[0])

    sec_g = np.mean([
        (run(5.0, 0.6, s) - run(5.0, 0.4, s)) / 0.2 for s in (101, 202)
    ])
    pmc_g = float(res["dT_dg"][0])
    # forward-biased scattering pushes more photons to the transmission
    # detector: both must be positive and within a factor ~2
    assert pmc_g > 0 and sec_g > 0
    assert 0.4 < pmc_g / sec_g < 2.5, (pmc_g, sec_g)


@pytest.mark.slow
def test_pmc_gradient_mua_tight_vs_seed_averaged_fd():
    """pMC dT/dmua vs a CRN central difference averaged over seeds.
    CPU-budget gate: 12%; tools/validate_gradients.py runs
    the same comparison at >= 5e5 photons x 6+ seeds where the pMC score
    agrees with FD to ~1e-2 (documented path to 1e-3: more seeds, since
    the residual is the FD's own Monte Carlo error)."""
    res = detector_gradients(CONFIG, nphotons=40000, n_lanes=8192, seed=3)
    parsed, scene, cfg, pi = (res["parsed"], res["scene"], res["cfg"],
                              res["prim_index"])

    def run(mua, seed):
        sc = _set_prim_optics(scene, pi, 5.0, mua, 0.5, 1.0)
        tot, _, n = _forward(parsed, sc, cfg, seed, inverse_prim=pi + 1)
        return float(tot[0]) / n

    h = 0.05
    fds = [(run(0.5 + h, s) - run(0.5 - h, s)) / (2 * h)
           for s in (3, 17, 29, 41)]
    fd = float(np.mean(fds))
    pmc = float(res["dT_dmua"][0]) / res["launched"]
    assert abs(pmc - fd) / abs(fd) < 0.12, (pmc, fd, fds)


@pytest.mark.slow
def test_n_gradient_sign_and_consistency():
    """The CRN n-derivative: a higher sphere index increases internal
    reflection, reducing the transmission detector total (negative
    gradient); two step sizes with different seeds must agree in sign."""
    # CRN noise scales ~1/(h sqrt(N)): at the high-statistics gradient
    # (~ -3.4e-3/photon) the sign needs N h^2 large enough for >3 sigma.
    # n_method="fd" explicitly: this config sits AT the matched index
    # n=1.0, where the true derivative is a quadratic minimum (score = 0
    # exactly, no Fresnel events) and the secant measures the curvature
    # response -- the documented out-of-score-domain case
    r1 = detector_gradients(CONFIG, nphotons=100000, n_lanes=8192, seed=3,
                            want_n=True, h_n=0.1, n_method="fd")
    r2 = detector_gradients(CONFIG, nphotons=100000, n_lanes=8192,
                            seed=17, want_n=True, h_n=0.12,
                            n_method="fd")
    # at n=1.0 raising n creates a mismatch at the sphere surface
    d1 = float(r1["dT_dn"][0])
    d2 = float(r2["dT_dn"][0])
    assert d1 < 0 and d2 < 0, (d1, d2)


@pytest.mark.slow
def test_radius_gradient_sign():
    """Shrinking the tau=4 sphere increases ballistic transmission, so
    dT/dradius of the transmission detector must be negative."""
    res = detector_gradients(CONFIG, nphotons=40000, n_lanes=8192, seed=3,
                             shape_param="radius", h_shape=0.05)
    assert float(res["dT_dradius"][0]) < 0


@pytest.mark.slow
def test_joint_recovery_reaches_noise_floor():
    """Gradient descent on (mus, mua, g, n) jointly against 3 detector
    targets (res/inverse_test4.toml): the error must improve from the
    perturbed start (-0.0096) to near the MC noise floor.  With 4
    unknowns and 3 targets the parameter vector itself is not uniquely
    identifiable; the gate is objective convergence."""
    from rsmcrt_tpu.inverse import inverse_gradient_descent

    theta, hist = inverse_gradient_descent(
        "res/inverse_test4.toml", nsteps=6, nphotons=10000, n_lanes=4096,
        lr=0.15, seed=11, verbose=False)
    best = max(h["error"] for h in hist)
    assert hist[0]["error"] < -0.008
    assert best > -0.004, [h["error"] for h in hist]


@pytest.mark.slow
def test_radius_recovery_converges():
    """SDF-shape recovery: starting from radius 0.65 with optics at the
    truth, CRN-gradient descent recovers the truth radius 0.8 within MC
    noise (the reference cannot search geometry at all)."""
    from rsmcrt_tpu.inverse import inverse_gradient_descent

    theta, hist = inverse_gradient_descent(
        "res/inverse_radius.toml", nsteps=8, nphotons=10000, n_lanes=4096,
        lr=0.08, seed=11, find=[], shape_params=["radius"],
        verbose=False)
    assert abs(theta["radius"] - 0.8) < 0.06, theta
    assert max(h["error"] for h in hist) > hist[0]["error"] + 0.002


@pytest.mark.slow
def test_recovery_uses_scores_with_zero_fd_forwards(monkeypatch):
    """In the score-valid domain (n away from matched index, radius-like
    shape), the optimizer must take gradients for ALL five parameter
    classes from the single forward run per step -- no CRN-FD forwards
    (VERDICT r4 next #3)."""
    import rsmcrt_tpu.inverse as inv
    from rsmcrt_tpu.inverse import inverse_gradient_descent

    def boom(*a, **k):
        raise AssertionError("CRN-FD forward run in score mode")

    monkeypatch.setattr(inv, "_crn_fd_totals", boom)
    # joint (mus, mua, g, n) descent: n starts at 1.1 vs truth 1.3 --
    # Fresnel events exist, the (angular-complete) n-score is live
    theta, hist = inverse_gradient_descent(
        "res/inverse_test4.toml", nsteps=3, nphotons=8000, n_lanes=4096,
        lr=0.15, seed=11, verbose=False)
    assert any(h["grads"].get("n") for h in hist)
    # radius descent on the boundary-extinction score
    theta, hist = inverse_gradient_descent(
        "res/inverse_radius.toml", nsteps=3, nphotons=8000, n_lanes=4096,
        lr=0.08, seed=11, find=[], shape_params=["radius"],
        verbose=False)
    assert any(h["grads"].get("radius") for h in hist)


def test_set_prim_shape_roundtrip():
    from rsmcrt_tpu.kernels import setup
    from rsmcrt_tpu.inverse import _prim_group_slot, _set_prim_shape

    parsed, scene = setup("res/inverse_test.toml", kernel="inverse")
    g, m = _prim_group_slot(scene, 0)
    sc2 = _set_prim_shape(scene, 0, "radius", 0.5)
    assert float(np.asarray(sc2.group_params[g]["radius"])[m]) == 0.5
    # original untouched (f32 storage)
    assert np.isclose(
        float(np.asarray(scene.group_params[g]["radius"])[m]), 0.8
    )
    with pytest.raises(KeyError):
        _set_prim_shape(scene, 0, "bogus", 1.0)


def test_inverse_evaluate_matches_reference_definition():
    # reference: error = -(1/M) Sum |total/N - target| over detectors with
    # target != -1 (kernelsMod.f90:1766-1786)
    totals = np.array([100.0, 250.0, 30.0])
    targets = np.array([0.2, -1.0, 0.05])
    err = inverse_evaluate(totals, 1000, targets)
    expected = -0.5 * (abs(0.1 - 0.2) + abs(0.03 - 0.05))
    assert np.isclose(err, expected)
