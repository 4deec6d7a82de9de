"""Where JAX's persistent compilation cache lives.

``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is left to
JAX.  Otherwise the cache goes to ``<repo>/.jax_cache``: a fixed path, so a
later run finds what an earlier one compiled (the path is part of the cache
key), and inside the checkout, which is all the program writes to.
"""

from __future__ import annotations

import os

__all__ = ["compile_cache_dir", "enable_compile_cache"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir(environ=None):
    """The cache directory this process should use."""
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO, ".jax_cache")


def enable_compile_cache(min_compile_secs=1.0):
    """Point JAX at :func:`compile_cache_dir` unless the environment
    already did; returns the directory in use."""
    import jax
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
