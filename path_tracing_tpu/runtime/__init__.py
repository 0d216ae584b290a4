"""Runtime utilities shared by all front-ends."""
from __future__ import annotations

import os

# the checkout root: the package directory's parent
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# fixed, git-ignored cache path: the path is part of the cache key, so a
# directory that moves between runs would never hit
CACHE_DIR = os.path.join(ROOT, ".jax_cache")


def setup_jax_cache() -> None:
    """Enable the persistent XLA compile cache.

    The scan-heavy integrator programs take a long time to compile cold; the
    cache makes later processes skip that.  When ``JAX_COMPILATION_CACHE_DIR``
    is set, JAX reads it itself and no directory is set here; otherwise the
    cache lives in ``<checkout>/.jax_cache``.
    """
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def nvidia_smi() -> str:
    """``name, power.limit`` of each NVIDIA card, one line per card, as
    ``nvidia-smi`` reports them (a child process that does not use JAX).
    Raises OSError or subprocess.SubprocessError when nvidia-smi fails."""
    import subprocess

    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60,
                       check=True)
    return r.stdout.strip()


def device_record() -> dict:
    """What every measurement names: platform, device kind and count, the
    JAX version, XLA_FLAGS and the card's name and power limit."""
    import subprocess

    import jax

    dev = jax.devices()[0]
    try:
        card = nvidia_smi().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = "not reported"
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()), "jax": jax.__version__,
            "xla_flags": os.environ.get("XLA_FLAGS", ""), "card": card}
