"""JAX-package parameters -> the port's ``state_dict``.

The JAX package's parameters come as a flat ``{"a/b/c": array}`` dict: the
key format of ``params_f16.npz`` and of a Flax parameter tree flattened with
"/" (an optional leading ``params/`` is dropped).  Names map one to one:

  ``layer_<i>``  -> ``layers.<i>``      (an ``nn.ModuleList`` entry)
  ``kernel``     -> ``weight``, transposed from (in, out) to (out, in)
  ``scale``      -> ``weight``          (LayerNorm)
  ``embedding``  -> ``weight``          (the token embedding table)
  ``bias``       -> ``bias``

The vocab head ``decoder/fc/kernel`` (D, V) becomes ``decoder.fc.weight``
(V, D): one contiguous row per vocab id, the layout ``ops/head_topk.py``
reads.  Any key left unmatched on either side raises."""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}


def torch_name(jax_key: str) -> Tuple[str, bool]:
    """(port parameter name, whether the array is transposed)."""
    parts = jax_key.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    *modules, leaf = parts
    if leaf not in _LEAF:
        raise KeyError(f"unknown JAX parameter leaf {leaf!r} in {jax_key!r}")
    modules = [re.sub(r"^layer_(\d+)$", r"layers.\1", m) for m in modules]
    return ".".join(modules + [_LEAF[leaf]]), leaf == "kernel"


def state_dict_from_jax(flat: Mapping[str, np.ndarray], model: torch.nn.Module
                        ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` for ``model`` holding the JAX parameters ``flat``,
    in the model's dtypes, on the CPU."""
    expected = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    unmatched = []
    for key, array in flat.items():
        name, transpose = torch_name(key)
        if name not in expected:
            unmatched.append(key)
            continue
        tensor = torch.from_numpy(np.asarray(array, dtype=np.float32))
        if transpose:
            tensor = tensor.T.contiguous()
        if tuple(tensor.shape) != tuple(expected[name].shape):
            raise ValueError(
                f"{key} -> {name}: shape {tuple(tensor.shape)} != "
                f"{tuple(expected[name].shape)}"
            )
        out[name] = tensor.to(expected[name].dtype)
    missing = sorted(set(expected) - set(out))
    if unmatched or missing:
        raise KeyError(
            f"unmatched JAX parameters: {sorted(unmatched)}; "
            f"port parameters with no JAX counterpart: {missing}"
        )
    return out


def load_jax_params(model: torch.nn.Module, flat: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Copy the JAX parameters ``flat`` into ``model`` (every key must match)."""
    model.load_state_dict(state_dict_from_jax(flat, model), strict=True)
    return model
