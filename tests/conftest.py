"""Test configuration: the suite runs on the CPU with 8 virtual devices, so
the multi-device sharding paths are exercised without a GPU.

``JAX_PLATFORMS`` overrides the platform: on a machine with a GPU,
``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu -p no:xdist`` runs
the tests that need the card (marked ``gpu``; they skip elsewhere).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
