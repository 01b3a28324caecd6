"""Small shared host-side helpers."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Mapping, Optional, Sequence, TypeVar

#: root of the checkout: the package's parent directory
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_T = TypeVar("_T")
_R = TypeVar("_R")


def fan_map(fn: Callable[[_T], _R], items: Sequence[_T]) -> List[_R]:
    """Map fn over items across a thread pool, order preserved.

    For per-stream host work whose heavy lifting happens in the ctypes C++
    engine (GIL released for the duration of the call): encode finalize
    (distrib.mesh.serialize_streams) and decode parse (core.decoder
    .parse_many).  Tiny batches stay serial -- pool setup would dominate.
    """
    if len(items) <= 2:
        return [fn(x) for x in items]
    workers = min(len(items), (os.cpu_count() or 2))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(fn, items))


def expand_inputs(patterns):
    """Glob-expand CLI input patterns (shared by batch_encode /
    batch_decode -- round-4 dedup); non-matching patterns pass through
    as literal paths so downstream loaders report them."""
    import glob as _glob
    paths = []
    for pat in patterns:
        hits = sorted(_glob.glob(pat))
        paths.extend(hits if hits else [pat])
    return paths


def compile_cache_dir(environ: Mapping[str, str] = os.environ
                      ) -> Optional[str]:
    """Where code must point JAX's persistent compile cache: None when
    JAX_COMPILATION_CACHE_DIR is set (JAX reads it itself and code sets
    nothing), else the fixed `.jax_cache/` inside the checkout (a fixed
    path, because the path is part of the cache key)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> None:
    """Apply the one compile-cache rule (see compile_cache_dir)."""
    path = compile_cache_dir()
    if path is None:
        return
    import jax
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
