"""The original (PyTorch) OpenViIC's checkpoints -> the port's ``state_dict``
(the port's counterpart of ``openviic_tpu/compat/torch_import.py``).

The original code saves ``model.state_dict()`` under ``state_dict``
(``trainers/base_trainer.py:138-153`` there).  Its names differ from the
port's in a few places, each mapped per parameter of the port's model:

 - DLCT's stacks ``layers_region.<i>``, ``layers_grid.<i>`` are the
   port's ``region.<i>``, ``grid.<i>`` (``region2grid.<i>`` and
   ``grid2region.<i>`` agree);
 - the Meshed-Memory decoder's ``fc_alphas.<j>`` is ``fc_alpha_<j>``;
 - the token embedding's ``components`` is ``embedding``;
 - the geometric attention's per-head ``fc_gs.<h>`` clones, Linear(d_g, 1)
   each, are one Linear(d_g, h) in the port: clone h is row h of its
   weight and element h of its bias;
 - everything else keeps its name.  Torch to torch, nothing is
   transposed.

The original's decode-state buffers (``running_*``, ``encoder_features``,
``encoder_padding_mask``) and its frozen sinusoid table ``pos_emb.weight``,
which the port computes, are skipped.  It covers the families whose
modules exist in both code bases: the standard transformer, AoA, M²,
the ORT, CAMO, ``UnifiedTransformer`` and DLCT; a port parameter with no
original counterpart (the MoE's experts, the LSTM embedding's Flax-named
cell, RSTNet's language model) is reported missing."""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import torch

_SKIP_SUFFIXES = (
    "running_keys",
    "running_values",
    "running_mask_self_attention",
    "running_seq",
    "encoder_features",
    "encoder_padding_mask",
    "pos_emb.weight",
)


def reference_name(name: str) -> str:
    """The original code's ``state_dict`` key of the port's parameter
    ``name`` (for ``fc_gs``, the clones' keys less their head index)."""
    name = re.sub(r"(^|\.)(region|grid)\.(\d+)\.", r"\1layers_\2.\3.", name)
    name = re.sub(r"(^|\.)fc_alpha_(\d+)\.", r"\1fc_alphas.\2.", name)
    return re.sub(r"(^|\.)embedding\.", r"\1components.", name)


def convert_torch_state_dict(state_dict: Mapping[str, torch.Tensor], model: torch.nn.Module
                             ) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """(the port's ``state_dict`` for ``model`` from the original's
    ``state_dict``, in the model's dtypes, on the CPU; the port parameters
    it has no value for; the original keys left unused)."""
    sd = {k: v for k, v in state_dict.items() if not k.endswith(_SKIP_SUFFIXES)}
    used = set()
    out: Dict[str, torch.Tensor] = {}
    missing: List[str] = []
    for name, target in model.state_dict().items():
        prefix, leaf = reference_name(name).rsplit(".", 1)
        if prefix.endswith("fc_gs"):  # one clone a head
            keys = [f"{prefix}.{h}.{leaf}" for h in range(target.shape[0])]
            if not all(k in sd for k in keys):
                missing.append(name)
                continue
            value = torch.stack([torch.as_tensor(sd[k]).reshape(-1) for k in keys])
            value = value.reshape(target.shape)
        else:
            keys = [reference_name(name)]
            if keys[0] not in sd:
                missing.append(name)
                continue
            value = torch.as_tensor(sd[keys[0]])
            if value.numel() != target.numel():
                raise ValueError(f"{keys[0]} -> {name}: shape {tuple(value.shape)} != "
                                 f"{tuple(target.shape)}")
            value = value.reshape(target.shape)
        used.update(keys)
        out[name] = value.detach().to(device="cpu", dtype=target.dtype).clone()
    unused = [k for k in sd if k not in used]
    return out, missing, unused


def load_reference_checkpoint(path: str, model: torch.nn.Module
                              ) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """``convert_torch_state_dict`` of the original code's ``*.pth`` file
    (the payload's ``state_dict``, or the payload itself): (the port's
    ``state_dict``, missing, unused), the JAX function's order.  The file
    is unpickled in full (``weights_only=False``, as the JAX package reads
    it): read only a file you trust."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    return convert_torch_state_dict(payload.get("state_dict", payload), model)
