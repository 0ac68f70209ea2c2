"""chip_smoke.py on the CPU: it refuses to report success without a GPU,
and its phase bodies run at tiny sizes (GPU vs CPU becomes CPU vs CPU)."""

import json
import os
import pathlib
import subprocess
import sys

import jax
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def main_result(tmp_path_factory):
    out = tmp_path_factory.mktemp("chip_smoke")
    old = chip_smoke.OUT_DIR
    chip_smoke.OUT_DIR = out
    try:
        yield chip_smoke.phase_main_path(nphotons=2000)
    finally:
        chip_smoke.OUT_DIR = old


@pytest.fixture
def gpu():
    """The first GPU; skips where JAX has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU")


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode != 0
    assert '"ok": true' not in run.stdout
    assert "no GPU" in run.stderr


def test_phase_main_path(main_result):
    assert main_result.launched == 2000
    assert main_result.tallies.jmean.shape == (200 ** 3,)


def test_phase_physics(main_result):
    chip_smoke.phase_physics(main_result, scat_photons=2000, scat_tol=10.0,
                             native_photons=8000, native_batches=16)


def test_phase_gpu_vs_cpu():
    # both "devices" are the CPU here: every lane must agree
    chip_smoke.phase_gpu_vs_cpu(n_lanes=256, n_steps=2, min_agree=1.0)


def test_phase_precision():
    chip_smoke.phase_precision(n_lanes=512)


def test_phase_four_devices():
    chip_smoke.phase_four_gpus(n_photons=4000, n_lanes=256, single_batches=4,
                               devices=jax.devices()[:4])


@pytest.mark.gpu
def test_precision_on_gpu(gpu):
    with jax.default_device(gpu):
        chip_smoke.phase_precision()


def test_last_line_format(capsys, monkeypatch):
    """The success line is exactly the contract's JSON object."""
    for name in ("phase_main_path", "phase_other_kernels", "phase_physics",
                 "phase_gpu_vs_cpu", "phase_precision"):
        monkeypatch.setattr(chip_smoke, name, lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "phase_device", lambda: {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1})
    assert chip_smoke.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
