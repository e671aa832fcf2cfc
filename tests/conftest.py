"""Test configuration: force CPU with a virtual 8-device mesh.

Multi-device sharding is validated on a virtual CPU mesh (the analog of
"multi-node testing without a real cluster"); GPU runs happen through
chip_smoke.py / bench.py.  Tests marked ``gpu`` need a GPU and skip here.

The backend is forced with jax.config.update after import (it wins over
any JAX_PLATFORMS in the environment).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
