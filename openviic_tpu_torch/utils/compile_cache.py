"""The kernels' persistent build cache (the port's counterpart of
``openviic_tpu/utils/compile_cache.py``).

In the JAX package the cache holds XLA's compiled programs; in the port the
compiler is nvcc, and the cache is the directory that ``ops/cuda_build.py``
builds its libraries into and loads them from.  A library's file name is a
hash of its sources and flags, so a process that finds a library there
loads it without starting nvcc, and a source that changed builds anew.
Without a cache the libraries go to the package's ``_build/``.

Enable it with ``TRAINING.COMPILATION_CACHE_DIR: <dir>`` or the
``OPENVIIC_COMPILE_CACHE=<dir>`` environment variable (the variable wins;
either set to an empty string force-disables the cache, one that an
earlier call enabled included).  Safe to call more than once; a later call
with another directory re-points the cache.  The trainer and
``CaptioningPipeline`` call it, as in the JAX package.
``OPENVIIC_COMPILE_CACHE_MIN_SECS`` (XLA's threshold of compile seconds
for an entry) has no counterpart: every library is kept."""

from __future__ import annotations

import os

from openviic_tpu_torch.utils.logging import setup_logger

logger = setup_logger()

def maybe_enable_compilation_cache(config=None) -> str | None:
    """Point ``ops.cuda_build`` at the configured cache directory (created
    if needed).  Returns the directory in use, or None when the cache is
    off."""
    from openviic_tpu_torch.ops import cuda_build

    path = os.environ.get("OPENVIIC_COMPILE_CACHE")
    if path is None and config is not None:
        try:
            path = config.TRAINING.get("COMPILATION_CACHE_DIR", None)
        except AttributeError:
            path = None
    current = cuda_build.cache_dir()
    if path == "":
        if current is not None:
            cuda_build.set_build_dir(None)
            logger.info("kernel build cache: force-disabled")
        return None
    if path is None:
        return None if current is None else str(current)
    path = os.path.abspath(os.path.expanduser(str(path)))
    if current is None or str(current) != path:
        os.makedirs(path, exist_ok=True)
        cuda_build.set_build_dir(path)
        logger.info("kernel build cache: %s", path)
    return path
