"""Device capability and compile-cache placement: the one place that
decides whether the device path runs on a GPU."""

import os
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def gpu_attached() -> bool:
    """True when JAX sees an NVIDIA GPU.  Errors from jax.devices() (for
    example a CUDA plugin that fails to start) propagate: a broken GPU
    install must not quietly become the host path."""
    import jax
    return any(d.platform == "gpu" for d in jax.devices())


def use_compile_cache() -> str:
    """Place JAX's persistent compilation cache and return its directory.

    JAX_COMPILATION_CACHE_DIR, when set, is used as is (JAX reads it
    itself) and nothing else is set.  Otherwise the cache goes to the fixed
    path <checkout>/.jax_cache: the path is part of the cache key, so it
    must not move between runs."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax
    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
