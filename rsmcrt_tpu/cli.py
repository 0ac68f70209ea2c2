"""Command line driver.

reference: app/main.f90 -- ``mcpolar`` takes a toml filename (default
``default.toml``) and the kernel is chosen by compile flag.  Here the
kernel is a runtime flag instead.

Usage::

    python -m rsmcrt_tpu.cli res/scat_test.toml
    python -m rsmcrt_tpu.cli --kernel escape res/escape.toml
    python -m rsmcrt_tpu.cli --kernel inverse res/inverse.toml
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="rsmcrt_tpu",
        description="Differentiable signed-distance-field Monte Carlo "
                    "radiation transfer",
    )
    ap.add_argument("config", nargs="?", default="default.toml",
                    help="TOML parameter file")
    ap.add_argument("--kernel", default="default",
                    choices=["default", "test", "escape", "inverse"],
                    help="simulation kernel (reference app/main.f90 "
                         "compile flags)")
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--nphotons", type=int, default=None,
                    help="override photon count")
    ap.add_argument("--lanes", type=int, default=None,
                    help="wavefront width (defaults by backend)")
    ap.add_argument("--survival-bias", action="store_true",
                    help="weighted packets + Russian roulette "
                         "(reference -DsurvivalBias)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    if args.kernel == "default":
        from .kernels import default_MCRT

        default_MCRT(args.config, data_dir=args.data_dir,
                     nphotons=args.nphotons, n_lanes=args.lanes,
                     survival_bias=args.survival_bias)
    elif args.kernel == "test":
        from .kernels import test_kernel

        out = test_kernel(args.config, nphotons=args.nphotons,
                          n_lanes=args.lanes)
        print("nscatt/photon:", out["nscatt"])
        print("first moments:\n", out["moments1"])
        print("second moments:\n", out["moments2"])
    elif args.kernel == "escape":
        from .escape import escape_function

        escape_function(args.config, data_dir=args.data_dir,
                        n_lanes=args.lanes)
    elif args.kernel == "inverse":
        from .inverse import inverse_MCRT

        inverse_MCRT(args.config, data_dir=args.data_dir,
                     n_lanes=args.lanes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
