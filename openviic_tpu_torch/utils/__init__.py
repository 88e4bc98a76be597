"""The trainer's utilities (the port's counterpart of ``openviic_tpu/utils``):
the logger and the metrics, timer and profiler hooks.  The JAX package's
compile cache has no counterpart: ``TRAINING.COMPILATION_CACHE_DIR`` does
nothing in the port."""

from openviic_tpu_torch.utils.logging import setup_logger

__all__ = ["setup_logger"]
