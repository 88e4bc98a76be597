"""The trainer's utilities (the port's counterpart of ``openviic_tpu/utils``):
the logger, the metrics, timer and profiler hooks, and the kernels' build
cache (``maybe_enable_compilation_cache``)."""

from openviic_tpu_torch.utils.compile_cache import maybe_enable_compilation_cache
from openviic_tpu_torch.utils.logging import setup_logger

__all__ = ["maybe_enable_compilation_cache", "setup_logger"]
