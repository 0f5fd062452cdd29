"""JAX runtime configuration shared by the CLI, bench, and test entry
points.

Two responsibilities:

* **Backend pinning.** ``BIOINFO1_PLATFORM=cpu|gpu`` selects the JAX
  backend for a process (``jax.config.update`` before first backend use).
  Unset, JAX picks its default: the GPU where there is one.

* **Persistent compilation cache.** The genome sweep / map-step
  specializations compile in seconds to tens of seconds, but every shape
  is canonical (pow-2 buckets, fixed band ladder), so one cache serves
  every run.  This is what makes repeated CLI invocations cheap - the
  reference re-does all its work from scratch each run
  (team_mapper.cpp:410-477).  Where ``JAX_COMPILATION_CACHE_DIR`` is set,
  JAX uses it and nothing here overrides it; otherwise the cache lives at
  the fixed path ``CACHE_DIR`` inside the checkout (``build/`` is
  git-ignored).
"""

from __future__ import annotations

import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_DIR = os.path.join(_REPO, "build", "xla_cache")

_configured = False


def enable_compile_cache(min_compile_secs: float = 1.0) -> None:
    """Turn on the persistent compilation cache (see module docstring)."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        try:
            os.makedirs(CACHE_DIR, exist_ok=True)
        except OSError:
            return  # read-only checkout: run without the cache
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


def configure_jax() -> None:
    """Idempotent; call before the first JAX backend use."""
    global _configured
    if _configured:
        return
    _configured = True
    import jax

    platform = os.environ.get("BIOINFO1_PLATFORM")
    if platform:
        jax.config.update("jax_platforms", platform)
    enable_compile_cache()
