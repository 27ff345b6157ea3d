"""Test configuration: force CPU with 8 virtual devices (multi-chip sharding
tests run on a virtual mesh, SURVEY.md section 4) and enable x64 so numeric
parity checks against the float64 reference math are meaningful."""

import os

# XLA_FLAGS must be set before the CPU backend initializes.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
# Serialize LLVM codegen inside XLA:CPU compilation: three full-suite runs
# segfaulted/aborted inside backend_compile_and_load on the large x64
# reference-parity programs (each at a different test, all in the biggest
# compiles; every crash site passes standalone) — parallel LLVM codegen is
# the prime suspect, and serializing it costs little here since the huge
# compiles are few.
if "xla_cpu_parallel_codegen_split_count" not in flags:
    flags = (flags + " --xla_cpu_parallel_codegen_split_count=1").strip()
os.environ["XLA_FLAGS"] = flags

import jax  # noqa: E402

# Pin the CPU through the config, whatever JAX_PLATFORMS says.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


import shutil  # noqa: E402
import subprocess  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture
def gpu_card():
    """Skip unless nvidia-smi lists a GPU. Decided when a test asks for it,
    never at import time, so every xdist worker collects the same tests.
    This process stays on the CPU; `gpu` tests drive the card from a child
    process, which then has the card to itself."""
    smi = shutil.which("nvidia-smi")
    listed = smi and subprocess.run(
        [smi, "-L"], capture_output=True, text=True, timeout=60
    ).stdout.strip()
    if not listed:
        pytest.skip("no NVIDIA GPU on this machine")
    return listed
