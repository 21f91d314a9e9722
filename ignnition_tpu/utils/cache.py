"""Where JAX's persistent compilation cache lives.

The rule, for every entry point of this repository (chip_smoke.py,
bench.py, the tools and the API's `compilation_cache_dir` setting):

  * JAX_COMPILATION_CACHE_DIR set: JAX reads it itself; no other directory
    is set in code;
  * otherwise the caller's directory, or by default `.jax_cache/` at the
    checkout root (listed in .gitignore). A fixed path matters: the path is
    part of the cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os
from typing import Optional

CHECKOUT_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT_ROOT, ".jax_cache")


def enable_compilation_cache(directory: Optional[str] = None) -> str:
    """Apply the rule above and return the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    d = str(directory or DEFAULT_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", d)
    return d
