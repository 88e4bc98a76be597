"""Checkpoints (the port's counterpart of the native backend of
``openviic_tpu/training/checkpoint.py``): one ``last_model.ckpt`` a run,
written atomically (a temporary file, then ``os.replace``) after every
epoch and copied to ``best_model.ckpt`` on improvement.

The file is the port's own, written by ``torch.save`` and read by
``torch.load(weights_only=True)``, so that reading one runs no pickled
code.  It holds

 - ``format``: ``FORMAT``, which a load requires;
 - ``model``: the model's ``state_dict``;
 - ``optimizer``: the optimizer's ``state_dict`` (the XE Adam, or the RL
   Adam in SCST) or None, and ``scheduler``: the Noam schedule's (None in
   SCST);
 - ``step``; ``generator``: the state generator's ``get_state()``, the
   stream of every dropout seed and SCST sample; ``numpy_rng_state``:
   numpy's global RNG state, restored on load as the JAX module does;
 - ``extras``: the trainer's ``epoch``, ``loader_epochs``, ``val_loss``,
   ``best_val_score``, ``patience`` and ``use_rl``.

A file that is not such a checkpoint (the JAX package's pickle among them)
is refused with a ``ValueError`` before anything is restored.  The JAX
module's split checkpoint for a frozen backbone (ROADMAP A.5.6) and its
Orbax backend (A.8) are not ported."""

from __future__ import annotations

import os
import pickle
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

LAST_NAME = "last_model.ckpt"
BEST_NAME = "best_model.ckpt"
FORMAT = "openviic_tpu_torch.checkpoint/1"
_KEYS = ("model", "optimizer", "scheduler", "step", "generator", "numpy_rng_state", "extras")


def _numpy_state() -> Dict[str, Any]:
    name, keys, pos, has_gauss, cached = np.random.get_state()
    return {"name": name, "keys": torch.from_numpy(keys.astype(np.int64)), "pos": int(pos),
            "has_gauss": int(has_gauss), "cached_gaussian": float(cached)}


def _set_numpy_state(state: Dict[str, Any]) -> None:
    np.random.set_state((state["name"], state["keys"].numpy().astype(np.uint32), state["pos"],
                         state["has_gauss"], state["cached_gaussian"]))


def save_checkpoint(path: str, model: torch.nn.Module, state: Dict[str, Any],
                    extras: Dict[str, Any]) -> None:
    """Write ``model`` and the step ``state`` (``optimizer``, ``scheduler``,
    ``step``, ``generator``) with ``extras`` to ``path``, atomically."""
    optimizer, scheduler = state.get("optimizer"), state.get("scheduler")
    payload = {
        "format": FORMAT,
        "model": model.state_dict(),
        "optimizer": None if optimizer is None else optimizer.state_dict(),
        "scheduler": None if scheduler is None else scheduler.state_dict(),
        "step": int(state["step"]),
        "generator": state["generator"].get_state(),
        "numpy_rng_state": _numpy_state(),
        "extras": dict(extras),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Optional[Dict[str, Any]]:
    """The checkpoint at ``path`` as a dict of its fields with the extras
    merged in, its tensors on the CPU; None when there is no file.  Sets
    numpy's global RNG state.  Raises ``ValueError`` for a file that is not
    the port's checkpoint."""
    if not os.path.exists(path):
        return None
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError, EOFError, ValueError) as exc:
        raise ValueError(f"{path} is not a checkpoint of openviic_tpu_torch (a JAX "
                         f"package checkpoint, or another file): {exc}") from exc
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"{path} is not a checkpoint of openviic_tpu_torch: no "
                         f"format {FORMAT!r}")
    missing = [k for k in _KEYS if k not in payload]
    if missing:
        raise ValueError(f"{path}: checkpoint lacks {missing}")
    _set_numpy_state(payload["numpy_rng_state"])
    out = {k: payload[k] for k in _KEYS if k != "extras"}
    out.update(payload["extras"])
    return out


class NativeBackend:
    """The single-file backend (this module's functions)."""

    LAST_NAME = LAST_NAME
    BEST_NAME = BEST_NAME

    def save_checkpoint(self, path, model, state, extras):
        save_checkpoint(path, model, state, extras)

    def load_checkpoint(self, path):
        return load_checkpoint(path)

    def copy(self, src: str, dst: str) -> None:
        shutil.copyfile(src, dst)

    def exists(self, path: str) -> bool:
        return os.path.isfile(path)

    def wait(self) -> None:  # saves are synchronous
        pass


def get_backend(name: str = "native"):
    """The checkpoint backend named by ``TRAINING.CHECKPOINT_BACKEND``."""
    name = (name or "native").lower()
    if name == "orbax":
        raise NotImplementedError("TRAINING.CHECKPOINT_BACKEND: orbax is not ported "
                                  "(ROADMAP A.8)")
    if name == "native":
        return NativeBackend()
    raise ValueError(f"unknown checkpoint backend {name!r}")
