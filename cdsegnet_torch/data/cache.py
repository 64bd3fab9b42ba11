"""Cross-worker scene cache (reference `pointcept/utils/cache.py:20-56`).

Port of `cdsegnet_tpu/data/cache.py`: each decoded scene is kept as an
uncompressed ``.npz`` in a shared cache directory (tmpfs where there is one)
and read back with ``mmap_mode="r"``, so a scene is decoded once and read
many times. The key (the first 16 hex digits of the SHA-1 of the scene's
path), the directory and the format are JAX's: a file written by either
package is read by the other.

The write differs on purpose. JAX's ``np.savez(path + ".tmp<pid>")`` writes
``<key>.npz.tmp<pid>.npz`` (numpy appends the suffix), so its rename fails
with `FileNotFoundError` on the first scene and leaves that file behind.
Here the archive is written through an open file object under a temporary
name and renamed atomically over ``<key>.npz``.
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Callable, Dict, Optional

import numpy as np


def default_cache_dir() -> str:
    """``CDSEG_CACHE_DIR``, else ``/dev/shm/cdsegnet_cache`` where
    ``/dev/shm`` exists, else ``/tmp/cdsegnet_cache``."""
    return os.environ.get(
        "CDSEG_CACHE_DIR",
        "/dev/shm/cdsegnet_cache" if os.path.isdir("/dev/shm") else "/tmp/cdsegnet_cache")


def cache_path(name: str, cache_dir: Optional[str] = None) -> str:
    """The cache file of the scene at ``name``."""
    key = hashlib.sha1(name.encode()).hexdigest()[:16]
    return os.path.join(cache_dir or default_cache_dir(), f"{key}.npz")


def shared_dict(name: str, loader: Callable[[], Dict[str, np.ndarray]],
                cache_dir: Optional[str] = None) -> Dict[str, np.ndarray]:
    """The cached arrays of ``name``, decoded by ``loader`` on first use.
    Only arrays and scalars are kept, as in JAX."""
    path = cache_path(name, cache_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if not os.path.exists(path):
        data = loader()
        arrays = {k: np.asarray(v) for k, v in data.items()
                  if isinstance(v, np.ndarray) or np.isscalar(v)}
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    loaded = np.load(path, mmap_mode="r", allow_pickle=False)
    return {k: loaded[k] for k in loaded.files}


def clear_cache(cache_dir: Optional[str] = None) -> None:
    """Remove every file of the cache directory."""
    cache_dir = cache_dir or default_cache_dir()
    if os.path.isdir(cache_dir):
        for f in os.listdir(cache_dir):
            try:
                os.remove(os.path.join(cache_dir, f))
            except OSError:
                pass
