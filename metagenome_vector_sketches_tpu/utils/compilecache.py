"""Persistent XLA compilation cache.

The CLIs run as independent array-job processes; without a persistent cache
every shard job re-pays the compiles of the same program shapes. Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this module
sets nothing; otherwise the cache lives at a fixed path inside the checkout
(``<repo>/.jax_cache``, gitignored), so a later process finds it again.
An empty directory is a cold cache.

Imported by the jax-using modules (ops.pairwise, ops.projection,
ann.flat_index) so pure-host entry points (codecs, legacy readers, query
outputs) never pay the jax import or the mkdir.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")

_done = False


def ensure() -> None:
    global _done
    if _done or os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    _done = True
    import jax
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
