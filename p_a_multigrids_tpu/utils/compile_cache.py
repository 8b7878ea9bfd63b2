"""Where the persistent XLA compilation cache lives.

One rule for every entry point (the CLI, ``bench.py``, ``chip_smoke.py``
and the test harness): when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads
it itself and nothing here changes it; otherwise the cache goes to
``.jax_cache/`` at the root of the checkout.  A fixed path matters: a cache
directory that moves between runs is never found again.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def cache_dir() -> str:
    """The directory the rule selects (not created here)."""
    return os.environ.get(ENV) or os.path.join(repo_root(), ".jax_cache")


def configure() -> str:
    """Apply the rule to this process's JAX config; returns the path."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
