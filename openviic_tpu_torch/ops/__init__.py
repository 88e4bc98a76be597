"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

No kernel has a backward, as none of the JAX package's Pallas kernels has
a VJP: ``refuse_grad`` makes every wrapper raise, on the CPU as on a card,
when autograd would need one."""

from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise when grad mode is on and a floating input requires grad: the
    kernel's output would carry no gradient, so training through it would
    be silently wrong.  ``tensors`` may hold tensors, dicts of them and
    ``None``."""
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        values = t.values() if isinstance(t, dict) else (t,)
        if any(isinstance(v, torch.Tensor) and v.is_floating_point() and v.requires_grad
               for v in values):
            raise RuntimeError(
                f"{name} has no backward (the JAX package's Pallas kernel has no VJP "
                "either): run it under torch.no_grad(), and unset OPENVIIC_PALLAS / "
                "OPENVIIC_GEO_FUSED for training")
