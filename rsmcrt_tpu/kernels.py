"""Simulation kernels: orchestration of setup -> run -> finalise.

reference: src/kernelsMod.f90 (default_MCRT :14, test_kernel :2069,
setup :2225, finalise :2321).  The escape-function and inverse kernels live
in :mod:`rsmcrt_tpu.escape` and :mod:`rsmcrt_tpu.inverse`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from .config import ParsedConfig, parse_params
from .detectors.detectors import totals as detector_totals
from .grid import CartGrid
from .io.writer import (
    read_checkpoint,
    write_checkpoint,
    write_data,
    write_detected_photons,
)
from .render import render_geometry
from .scenes import setup_simulation
from .sdfs.scene import Scene, build_scene
from .tally import as_volume, normalise_fluence
from .transport.engine import TransportConfig, simulate


#: Transport knobs per device, keyed by ``jax.Device.device_kind``; the
#: product kernels and bench.py both read them, so the default user path
#: IS the benchmarked path (the reference runs one hot loop for everyone,
#: kernelsMod.f90:1790).
#:
#: - ``lanes``: wavefront width cap B;
#: - ``dda_substeps``: K, voxel walls / chain rounds per megastep;
#: - ``chain_respawns``: C, in-chain respawn candidates per lane per
#:   megastep in fluenceless runs (fluence runs use 1: a photon spans
#:   several megasteps there);
#: - ``chunk_steps``: megasteps per dispatch between host checks;
#: - ``min_lanes``: narrowest width of the straggler-tail shrink ladder;
#: - ``bench_photons`` / ``bench_photons_fluenceless``: bench.py budgets.
#:
#: The ``cpu`` row keeps test runs small and compiles fast.
DEVICE_TABLE = {
    "cpu": dict(lanes=1 << 12, dda_substeps=8, chain_respawns=1,
                chunk_steps=512, min_lanes=4096, bench_photons=4_000,
                bench_photons_fluenceless=8_000),
    # H100 SXM (700 W): B, K and C from a main-phase sweep of the sphere
    # scene (B in {32k, 128k, 512k} x K in {16, 64} x C in {1, 3}; the
    # largest B and K were fastest with fluence on and off, and C=3 with
    # fluence off; PERF.md, PR 1).  chunk_steps, min_lanes and the bench
    # budgets are unmeasured starting points.
    "NVIDIA H100 80GB HBM3": dict(
        lanes=1 << 19, dda_substeps=64, chain_respawns=3,
        chunk_steps=48, min_lanes=2048, bench_photons=16_000_000,
        bench_photons_fluenceless=128_000_000),
}


def device_knobs(device_kind: str | None = None) -> dict:
    """The :data:`DEVICE_TABLE` row of ``device_kind`` (default: the
    first JAX device).  An unknown device is an error, never a default."""
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    try:
        return DEVICE_TABLE[device_kind]
    except KeyError:
        raise ValueError(
            f"no transport knobs for device_kind {device_kind!r}: add a "
            f"row to rsmcrt_tpu.kernels.DEVICE_TABLE "
            f"(known: {sorted(DEVICE_TABLE)})") from None


def default_lanes(nphotons: int, device_kind: str | None = None) -> int:
    """Wavefront width: the largest power of two within both the photon
    budget and the device's lane cap (at least 256)."""
    cap = device_knobs(device_kind)["lanes"]
    lanes = 1
    while lanes * 2 <= min(cap, max(nphotons, 1)):
        lanes *= 2
    return max(lanes, 256)


def fast_path_defaults(fluence: bool = True,
                       device_kind: str | None = None) -> dict:
    """Device-tuned fast-path ``TransportConfig`` knobs.  Chaining falls
    back to the plain walk silently when a scene/feature cannot chain."""
    row = device_knobs(device_kind)
    return {
        "chain_scatter": True,
        "dda_substeps": row["dda_substeps"],
        "chain_respawns": 1 if fluence else row["chain_respawns"],
    }


@dataclass
class SimResult:
    parsed: ParsedConfig
    scene: Scene
    tallies: object
    bank: object
    launched: int
    steps: int
    elapsed: float

    @property
    def nscatt_per_photon(self):
        return float(self.tallies.nscatt) / max(self.launched, 1)

    @property
    def photons_per_second(self):
        return self.launched / self.elapsed if self.elapsed > 0 else 0.0


def setup(input_file: str | Path, kernel: str = "default",
          res_dir=None) -> tuple[ParsedConfig, Scene]:
    """Parse config and build the scene
    (reference: kernelsMod.f90:2225-2319)."""
    parsed = parse_params(input_file, res_dir=res_dir, kernel=kernel)
    prims = setup_simulation(
        parsed.settings.experiment, parsed.geometry,
        res_dir=Path(res_dir) if res_dir else Path(input_file).parent,
    )
    scene = build_scene(prims)
    return parsed, scene


def _console_pbar(launched, n_target, width=30):
    """One-line console progress (reference: the external `pbar` utility
    driven from the photon loop, kernelsMod.f90:1856-1862)."""
    frac = min(launched / max(n_target, 1), 1.0)
    fill = int(frac * width)
    bar = "#" * fill + "-" * (width - fill)
    print(f"\r[{bar}] {launched}/{n_target} photons", end="",
          flush=True)


def transport_config(parsed: ParsedConfig, nphotons=None, n_lanes=None,
                     survival_bias=False, record_moments=False,
                     max_scatter_order=0, max_steps=2_000_000,
                     history=False, record_fluence=True,
                     record_phasor=None) -> TransportConfig:
    """The ``TransportConfig`` of a forward run of ``parsed`` on this
    device (what :func:`run_MCRT` simulates)."""
    st = parsed.settings
    nphotons = int(nphotons if nphotons is not None else st.nphotons)
    n_lanes = int(n_lanes if n_lanes is not None else
                  default_lanes(nphotons))
    track_history = history or st.trackHistory
    if record_phasor is None:
        record_phasor = st.phasor
    return TransportConfig(
        record_phasor=bool(record_phasor),
        nphotons=nphotons,
        n_lanes=n_lanes,
        survival_bias=survival_bias,
        record_fluence=record_fluence,
        record_emission=True,
        record_moments=record_moments,
        max_scatter_order=max_scatter_order,
        max_steps=max_steps,
        history_len=64 if track_history else 0,
        max_tracks=4096 if track_history else 0,
        roulette_bounces=st.roulette_bounces,
        roulette_chance=st.roulette_chance,
        **fast_path_defaults(fluence=record_fluence),
    )


def run_MCRT(parsed: ParsedConfig, scene: Scene, nphotons=None,
             n_lanes=None, survival_bias=False, seed=None,
             record_moments=False, max_scatter_order=0,
             max_steps=2_000_000, input_file=None,
             history=False, record_fluence=True,
             record_phasor=None, progress_bar=False) -> SimResult:
    """Forward simulation (reference: run_MCRT, kernelsMod.f90:1790-1898),
    including the live tev viewer (:1874-1887) and periodic checkpointing
    (:1863) via the chunked-progress callback."""
    st = parsed.settings
    cfg = transport_config(
        parsed, nphotons=nphotons, n_lanes=n_lanes,
        survival_bias=survival_bias, record_moments=record_moments,
        max_scatter_order=max_scatter_order, max_steps=max_steps,
        history=history, record_fluence=record_fluence,
        record_phasor=record_phasor)
    nphotons = cfg.nphotons
    track_history = cfg.history_len > 0
    key = jax.random.key(seed if seed is not None else st.iseed)

    tev = None
    if st.tev:
        from .io.tev import TevIPC

        tev = TevIPC()
        if tev.connected:
            tev.close_image(st.experiment)
            tev.create_image(st.experiment, st.grid.nxg, st.grid.nzg)

    ckpt_state = {"next": st.ckptfreq}

    def progress(launched, n_target, step, carry):
        if progress_bar:
            _console_pbar(launched, n_target)
        if tev is not None and tev.connected:
            from .io.tev import tev_slices

            vol = np.asarray(as_volume(st.grid, carry.tallies.jmean))
            tev_slices(tev, st.experiment, vol)
        if input_file is not None and launched >= ckpt_state["next"]:
            ckpt_state["next"] = launched + st.ckptfreq
            write_checkpoint(
                str(input_file), st.ckptfile, launched,
                np.asarray(as_volume(st.grid, carry.tallies.jmean)),
            )

    want_progress = (tev is not None or input_file is not None
                     or progress_bar)
    knobs = device_knobs()
    t0 = time.perf_counter()
    tallies, bank, launched, steps = simulate(
        scene, parsed.source, st.grid, key, cfg, bank=parsed.detectors,
        progress=progress if want_progress else None,
        chunk_steps=knobs["chunk_steps"], min_lanes=knobs["min_lanes"],
    )
    jax.block_until_ready(tallies.jmean)
    elapsed = time.perf_counter() - t0
    if progress_bar:
        _console_pbar(int(launched), nphotons)
        print()
    if tev is not None:
        tev.close()
    if track_history and tallies.track_dropped is not None:
        trunc, over = (int(v) for v in np.asarray(tallies.track_dropped))
        if trunc or over:
            # history losses are counted, never silent (VERDICT r3 #4):
            # ring-truncated early events of deep paths + per-chunk slot
            # overflow (raise history_len / max_tracks to capture more)
            print(f"[history] dropped: {trunc} ring-truncated events, "
                  f"{over} overflowed tracks (of "
                  f"{int(tallies.track_count)} kept)")
    return SimResult(
        parsed=parsed, scene=scene, tallies=tallies, bank=bank,
        launched=int(launched), steps=int(steps), elapsed=elapsed,
    )


def finalise(result: SimResult, data_dir: str | Path = "data",
             verbose=True):
    """Normalise and write outputs
    (reference: finalise, kernelsMod.f90:2321-2416)."""
    st = result.parsed.settings
    grid = st.grid
    data_dir = Path(data_dir)
    n = result.launched

    metadata = {
        "grid_data": "fluence map",
        "real_size": f"{float(grid.xmax)} {float(grid.ymax)} "
                     f"{float(grid.zmax)}",
        "nphotons": n,
        "source": st.source,
        "experiment": st.experiment,
        "units": st.units,
    }

    jmean = normalise_fluence(grid, as_volume(grid, result.tallies.jmean), n)
    write_data(np.asarray(jmean), data_dir / "jmean" / st.outfile,
               overwrite=st.overwrite, metadata=metadata)

    emission = normalise_fluence(
        grid, as_volume(grid, result.tallies.emission), n
    )
    write_data(np.asarray(emission),
               data_dir / "emission" / st.rendersourcefile,
               overwrite=st.overwrite, metadata=metadata)

    if st.absorb:
        # reference gates the absorb volume on [simulation] absorb
        # (parse.f90:170, kernelsMod.f90:2388)
        write_data(np.asarray(as_volume(grid, result.tallies.absorb)),
                   data_dir / "absorb" / st.outfile_absorb,
                   overwrite=st.overwrite, metadata=metadata)

    if result.tallies.phasor_re.shape[0] > 0:
        # complex phasor field (reference allocates phasor in
        # iarray.f90:14; phase accumulates in photon.f90:712-781 for the
        # dslit/aperture sources).  Written as magnitude + components so
        # fringe patterns are directly inspectable.
        pre = np.asarray(as_volume(grid, result.tallies.phasor_re))
        pim = np.asarray(as_volume(grid, result.tallies.phasor_im))
        mag = np.sqrt(pre * pre + pim * pim)
        for name, vol in (("phasor.nrrd", mag), ("phasor_re.nrrd", pre),
                          ("phasor_im.nrrd", pim)):
            write_data(vol, data_dir / "phasor" / name,
                       overwrite=st.overwrite, metadata=metadata)

    if result.bank is not None and result.bank.n_detectors > 0:
        write_detected_photons(result.bank, n, data_dir / "detectors")

    if verbose:
        print(f"Average # of scatters per photon: "
              f"{result.nscatt_per_photon:.4f}")
        print(f"Photons/s: {result.photons_per_second:.4g}")
    return jmean


def display_settings(parsed: ParsedConfig, input_file,
                     kernel_type: str = "default") -> str:
    """Run-provenance banner echoing the parsed configuration
    (reference: display_settings, kernelsMod.f90:2441-2485).  Returns the
    banner string (callers print it when verbose)."""
    st = parsed.settings
    w = 50
    lines = ["#" * 20 + " Settings " + "#" * 20]

    def row(text):
        pad = max(w - 2 - len(text), 0)
        lines.append("# " + text + " " * pad + "#")

    row(f"Config file: {Path(input_file).name}")
    row(f"Using: {kernel_type} kernel")
    row(f"Light source: {st.source}")
    sp = parsed.source.params
    pos = sp.get("position")
    if st.source == "point" and pos is not None:
        row("Light Source Position: [%.4g, %.4g, %.4g]"
            % tuple(float(x) for x in np.asarray(pos)[:3]))
    elif sp.get("direction") is not None:
        row("Light direction: [%.4g, %.4g, %.4g]"
            % tuple(float(x) for x in np.asarray(sp["direction"])[:3]))
    row(f"Geometry: {st.experiment}")
    row(f"Seed: {st.iseed}")
    row(f"Photons: {st.nphotons}")
    if st.tev:
        row("Tev enabled!")
    if st.render_geom:
        row("Render geometry to file enabled!")
    if st.overwrite:
        row("Overwrite Enabled!")
    if st.absorb:
        row("Energy absorbed will be written to file.")
    lines.append("#" * w)
    return "\n".join(lines)


def default_MCRT(input_file: str | Path, data_dir="data", nphotons=None,
                 n_lanes=None, survival_bias=False, verbose=True,
                 res_dir=None) -> SimResult:
    """The standard forward kernel (reference: kernelsMod.f90:14-82),
    including checkpoint resume (:52-75)."""
    parsed, scene = setup(input_file, res_dir=res_dir)
    st = parsed.settings
    if verbose:
        print(display_settings(parsed, input_file))

    resume_jmean = None
    if st.loadckpt:
        toml_name, nrun, resume_jmean = read_checkpoint(
            st.ckptfile, st.grid.shape
        )
        ckpt_toml = Path(toml_name)
        if not ckpt_toml.exists():
            ckpt_toml = Path(input_file).parent / toml_name
        parsed, scene = setup(ckpt_toml, res_dir=res_dir)
        st = parsed.settings
        st.iseed = st.iseed * 101
        st.nphotons = st.nphotons - nrun

    result = run_MCRT(parsed, scene, nphotons=nphotons, n_lanes=n_lanes,
                      survival_bias=survival_bias,
                      input_file=input_file if st.ckptfreq > 0 else None,
                      progress_bar=verbose)

    if resume_jmean is not None:
        import dataclasses

        merged = result.tallies.jmean + jnp.asarray(
            resume_jmean.reshape(-1), result.tallies.jmean.dtype
        )
        result = dataclasses.replace(
            result, tallies=dataclasses.replace(result.tallies,
                                                jmean=merged)
        )

    if st.render_geom:
        img = render_geometry(
            scene,
            [float(st.grid.xmax), float(st.grid.ymax), float(st.grid.zmax)],
            st.render_size,
        )
        write_data(img, Path(data_dir) / st.rendergeomfile,
                   overwrite=True)

    finalise(result, data_dir=data_dir, verbose=verbose)
    return result


def checkpoint_now(input_file, result: SimResult, data_dir="data"):
    """Write a reference-format checkpoint
    (reference: writer.f90:426-457)."""
    st = result.parsed.settings
    grid = st.grid
    return write_checkpoint(
        str(input_file), st.ckptfile, result.launched,
        np.asarray(as_volume(grid, result.tallies.jmean)),
    )


def test_kernel(input_file: str | Path, end_early: bool = True,
                nphotons=None, n_lanes=None, write_files=True,
                res_dir=None):
    """Validation kernel recording scatter-order position moments
    (reference: test_kernel, kernelsMod.f90:2069-2182)."""
    parsed, scene = setup(input_file, res_dir=res_dir)
    result = run_MCRT(
        parsed, scene, nphotons=nphotons, n_lanes=n_lanes,
        record_moments=True,
        max_scatter_order=4 if end_early else 0,
        max_steps=200_000,
    )
    n = result.launched
    m1 = np.asarray(result.tallies.mom_pos) * 10.0 / n
    m2 = np.asarray(result.tallies.mom_pos2) * 100.0 / n
    nscatt = result.nscatt_per_photon
    if write_files:
        with open("nscatt.dat", "w") as fh:
            fh.write(f"{nscatt}\n")
        with open("positions.dat", "w") as fh:
            for row in m1:
                fh.write(f"{row[0]} {row[1]} {row[2]}\n")
            for row in m2:
                fh.write(f"{row[0]} {row[1]} {row[2]}\n")
    return dict(nscatt=nscatt, moments1=m1, moments2=m2, result=result)
