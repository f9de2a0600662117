"""Test harness config: force a CPU backend with 8 virtual devices so the
sharded code paths (psum merges, halo exchange, distributed FFT) run in CI
without an accelerator.
"""

import os
import re

os.environ["JAX_PLATFORMS"] = "cpu"
# Normalize (not just append) the device-count flag: a shell that exported
# a different count (e.g. =4 while experimenting with the dryrun) would
# otherwise silently run the 8-device sharding tests short of devices.
flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
               os.environ.get("XLA_FLAGS", "")).strip()
os.environ["XLA_FLAGS"] = (
    flags + " --xla_force_host_platform_device_count=8"
).strip()
