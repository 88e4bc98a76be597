"""JAX-package parameters -> the port's ``state_dict``.

The JAX package's parameters come as a flat ``{"a/b/c": array}`` dict: the
key format of ``params_f16.npz`` and of a Flax parameter tree flattened with
"/" (an optional leading ``params/`` is dropped).  Names map one to one:

  ``layer_<i>``  -> ``layers.<i>``      (an ``nn.ModuleList`` entry)
  ``region_<i>``, ``grid_<i>``, ``region2grid_<i>``, ``grid2region_<i>``
                 -> ``region.<i>`` ...  (DLCT's four stacks; its
                    ``region_proj``, ``grid_proj``, ``fc_gs``,
                    ``layer_norm_region`` and ``layer_norm_grid`` keep
                    their names)
  ``kernel``     -> ``weight``, transposed from (in, out) to (out, in)
  ``scale``      -> ``weight``          (LayerNorm)
  ``embedding``  -> ``weight``          (the token embedding table)
  ``bias``       -> ``bias``
  ``m_k``, ``m_v`` -> the same name (the augmented memory's raw slots,
                    (1, m, h * d), not transposed)

The frozen language model's backbones keep their JAX names
(``backbone/hf/encoder/layer/<i>/...`` becomes
``backbone.hf.encoder.layer.<i>....``; the mini backbone's ``attn_<i>``,
``ln1_<i>``, ``ff1_<i>`` ... stay as they are).  The mini backbone's
attention is Flax's ``MultiHeadDotProductAttention``, whose kernels are
3-D: query/key/value (in, h, d) and out (h, d, out), with (h, d) biases;
they are flattened to (in, h * d), (h * d, out) and (h * d,) first.

The vocab head ``decoder/fc/kernel`` (D, V) becomes ``decoder.fc.weight``
(V, D): one contiguous row per vocab id, the layout ``ops/head_topk.py``
reads.  Any key left unmatched on either side raises."""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias",
         "m_k": "m_k", "m_v": "m_v"}


def torch_name(jax_key: str) -> Tuple[str, bool]:
    """(port parameter name, whether the array is transposed)."""
    parts = jax_key.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    *modules, leaf = parts
    if leaf not in _LEAF:
        raise KeyError(f"unknown JAX parameter leaf {leaf!r} in {jax_key!r}")
    modules = [re.sub(r"^(region|grid|region2grid|grid2region)_(\d+)$", r"\1.\2",
                      re.sub(r"^layer_(\d+)$", r"layers.\1", m)) for m in modules]
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
        if tensor.dim() == 3 and transpose:  # a DenseGeneral kernel
            out_proj = key.split("/")[-2] == "out"
            tensor = tensor.reshape(-1, tensor.shape[-1]) if out_proj else \
                tensor.reshape(tensor.shape[0], -1)
        elif tensor.dim() == 2 and name.endswith(".bias"):  # its (h, d) bias
            tensor = tensor.reshape(-1)
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
