"""Process set-up shared by every entry point (chip_smoke.py, bench.py,
__graft_entry__.py, the experiment CLIs): matmul precision, the persistent
compile cache, and the device record that every printed result carries.

Call `configure()` before the first JAX computation. Tests keep their own
CPU set-up (tests/conftest.py) and do not call it.
"""

from __future__ import annotations

import os
import pathlib
import subprocess

import jax

# A fixed directory inside the checkout: the cache key includes the path, so a
# temp, pid or time path would never hit.
DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def compile_cache_dir() -> str:
    """`JAX_COMPILATION_CACHE_DIR` when set, else the checkout's `.jax_cache`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_CACHE_DIR)


def configure() -> None:
    # On the GPU a float32 matmul runs in TF32 (~3 significant digits) unless
    # asked otherwise. ADMM convergence tracks the precision of its KKT
    # solves and G sweeps, and the golden comparisons need full f32, so pin
    # "highest" for the whole process.
    jax.config.update("jax_default_matmul_precision", "highest")
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())


def card_info() -> str:
    """Name and power limit of each card, as nvidia-smi reports them (one
    child process, which does not import JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"not available ({type(e).__name__})"
    return " | ".join(ln.strip() for ln in out.splitlines() if ln.strip())


def device_record() -> dict:
    """The device fields every printed result names."""
    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "device_kind": d.device_kind,
        "device_count": len(jax.devices()),
        "card": card_info(),
    }


def require_gpu() -> None:
    """Refuse to run anywhere but a GPU: a measurement that lands on the CPU
    is not a device measurement, so there is no fallback."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"no GPU found (JAX platform is {platform!r}); this entry point "
            "runs only on a GPU"
        )
