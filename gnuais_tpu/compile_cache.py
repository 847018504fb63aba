"""The persistent XLA compilation cache, in one place.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set (JAX reads it itself);
otherwise the cache lives at the fixed ``<checkout>/.jax_cache`` — the
path is part of the cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return the path.  Touches only configuration, so it is safe before
    jax.distributed.initialize."""
    import jax

    path = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(CHECKOUT / ".jax_cache"))
    jax.config.update("jax_compilation_cache_dir", path)
    return path
