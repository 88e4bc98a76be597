"""PyTorch/CUDA port of ``openviic_tpu`` for one NVIDIA H100.

The package imports ``torch`` and numpy only; it shares no module with the
JAX package.  Entry points (``builders.build_model``,
``serving.CaptioningPipeline``) run on ``device="cuda"`` unless the caller
asks for the CPU, where every kernel wrapper runs its plain PyTorch version.
"""
