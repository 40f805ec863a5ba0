"""Runtime platform helpers: kernel choice and the persistent compile cache."""

from __future__ import annotations

import os

import jax

#: fixed compile-cache location used when ``JAX_COMPILATION_CACHE_DIR`` is
#: unset (the path is part of the cache key, so it must not move)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def kernel_route(platform: str | None = None) -> str:
    """Which implementation a stage with a hand-written kernel runs.

    ``"triton"`` (the Pallas kernel, compiled through Triton) on the GPU,
    ``"xla"`` (the plain ``jax.numpy`` form) everywhere else.  Decided from
    ``jax.default_backend()`` unless ``platform`` is given.  Never selects
    the Pallas interpreter: only tests ask for that, by name.
    """
    platform = platform or jax.default_backend()
    return "triton" if platform == "gpu" else "xla"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as JAX reads it and
    no other path is set here.  Otherwise the cache lives at the fixed
    :data:`DEFAULT_CACHE_DIR`.  Every program is cached, however short its
    compile.
    """
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir
