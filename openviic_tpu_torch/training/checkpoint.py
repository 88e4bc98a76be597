"""Checkpoints (the port's counterpart of the native backend of
``openviic_tpu/training/checkpoint.py``): one ``last_model.ckpt`` a run,
written atomically (a temporary file, then ``os.replace``) after every
epoch and copied to ``best_model.ckpt`` on improvement.

The file is the port's own, written by ``torch.save`` and read by
``torch.load(weights_only=True)``, so that reading one runs no pickled
code.  It holds

 - ``format``: ``FORMAT``, which a load requires;
 - ``model``: the model's ``state_dict`` (its trainable part in a split
   checkpoint, whose ``frozen_file`` names the rest; None otherwise);
 - ``optimizer``: the optimizer's ``state_dict`` (the XE Adam, or the RL
   Adam in SCST) or None, and ``scheduler``: the Noam schedule's (None in
   SCST);
 - ``step``; ``generator``: the state generator's ``get_state()``, the
   stream of every dropout seed and SCST sample; ``numpy_rng_state``:
   numpy's global RNG state, restored on load as the JAX module does;
 - ``extras``: the trainer's ``epoch``, ``loader_epochs``, ``val_loss``,
   ``best_val_score``, ``patience`` and ``use_rl``.

A file that is not such a checkpoint (the JAX package's pickle among them)
is refused with a ``ValueError`` before anything is restored.

A model with a frozen backbone (RSTNet's language model, ``frozen_mask``
from ``optim.frozen_param_mask``) saves split, as the JAX module does: the
frozen tensors go once to ``frozen_params.ckpt`` beside the per-epoch
file (its own format, ``FROZEN_FORMAT``), which then holds only the
trainable tensors and ``frozen_file``, the name to stitch them with on
load.  The file on disk is held against the live tensors once per process
and path, and rewritten when it differs (a stale file of another run).

``get_backend("orbax")`` is the asynchronous, collective backend of
``training/orbax_backend.py`` (DCP directories ``last_model.orbax`` and
``best_model.orbax``)."""

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
FROZEN_NAME = "frozen_params.ckpt"
FROZEN_FORMAT = "openviic_tpu_torch.frozen/1"
_KEYS = ("model", "optimizer", "scheduler", "step", "generator", "numpy_rng_state", "extras")


def _numpy_state() -> Dict[str, Any]:
    name, keys, pos, has_gauss, cached = np.random.get_state()
    return {"name": name, "keys": torch.from_numpy(keys.astype(np.int64)), "pos": int(pos),
            "has_gauss": int(has_gauss), "cached_gaussian": float(cached)}


def _set_numpy_state(state: Dict[str, Any]) -> None:
    np.random.set_state((state["name"], state["keys"].numpy().astype(np.uint32), state["pos"],
                         state["has_gauss"], state["cached_gaussian"]))


# frozen files this process has written or found current
_VALIDATED_FROZEN: set = set()


def _load(path: str, fmt: str):
    """The dict ``torch.save`` wrote to ``path`` in format ``fmt``, read with
    ``weights_only``; ``ValueError`` for another file."""
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError, EOFError, ValueError) as exc:
        raise ValueError(f"{path} is not a checkpoint of openviic_tpu_torch (a JAX "
                         f"package checkpoint, or another file): {exc}") from exc
    if not isinstance(payload, dict) or payload.get("format") != fmt:
        raise ValueError(f"{path} is not a checkpoint of openviic_tpu_torch: no "
                         f"format {fmt!r}")
    return payload


def _frozen_file_current(path: str, frozen: Dict[str, torch.Tensor]) -> bool:
    """Whether ``path`` holds exactly the tensors ``frozen`` (checked once per
    process and path); a mismatch is logged for the caller to rewrite."""
    if path in _VALIDATED_FROZEN:
        return True
    if not os.path.exists(path):
        return False
    try:
        saved = _load(path, FROZEN_FORMAT)["tensors"]
        ok = set(saved) == set(frozen) and all(torch.equal(saved[k], frozen[k]) for k in frozen)
    except (ValueError, KeyError, TypeError):
        ok = False
    if ok:
        _VALIDATED_FROZEN.add(path)
    else:
        from openviic_tpu_torch.utils import setup_logger

        setup_logger().warning("stale %s does not match the live frozen tensors; rewriting",
                               path)
    return ok


def _split_weights(path: str, weights: Dict[str, torch.Tensor],
                   frozen_mask: Dict[str, bool]) -> Dict[str, torch.Tensor]:
    """The trainable part of ``weights``; the frozen part goes to the
    run's ``FROZEN_NAME`` unless it is already current there."""
    frozen_path = os.path.join(os.path.dirname(path) or ".", FROZEN_NAME)
    if frozen_path not in _VALIDATED_FROZEN:
        frozen = {k: v.detach().cpu() for k, v in weights.items()
                  if not frozen_mask.get(k, True)}
        if not _frozen_file_current(frozen_path, frozen):
            tmp = frozen_path + ".tmp"
            torch.save({"format": FROZEN_FORMAT, "tensors": frozen}, tmp)
            os.replace(tmp, frozen_path)
            _VALIDATED_FROZEN.add(frozen_path)
    return {k: v for k, v in weights.items() if frozen_mask.get(k, True)}


def save_checkpoint(path: str, model: torch.nn.Module, state: Dict[str, Any],
                    extras: Dict[str, Any], frozen_mask: Optional[Dict[str, bool]] = None
                    ) -> None:
    """Write ``model`` and the step ``state`` (``optimizer``, ``scheduler``,
    ``step``, ``generator``) with ``extras`` to ``path``, atomically.  With
    ``frozen_mask`` ({parameter name: trainable}) the frozen tensors go to
    ``FROZEN_NAME`` instead (see the module's docstring)."""
    optimizer, scheduler = state.get("optimizer"), state.get("scheduler")
    weights = model.state_dict()
    if frozen_mask is not None:
        weights = _split_weights(path, weights, frozen_mask)
    payload = {
        "format": FORMAT,
        "model": weights,
        "frozen_file": None if frozen_mask is None else FROZEN_NAME,
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
    merged in, its tensors on the CPU (a split checkpoint's ``model``
    stitched from both files); None when there is no file.  Sets numpy's
    global RNG state.  Raises ``ValueError`` for a file that is not the
    port's checkpoint."""
    if not os.path.exists(path):
        return None
    payload = _load(path, FORMAT)
    missing = [k for k in _KEYS if k not in payload]
    if missing:
        raise ValueError(f"{path}: checkpoint lacks {missing}")
    weights = payload["model"]
    if payload.get("frozen_file"):
        frozen_path = os.path.join(os.path.dirname(path) or ".", payload["frozen_file"])
        weights = {**_load(frozen_path, FROZEN_FORMAT)["tensors"], **weights}
    _set_numpy_state(payload["numpy_rng_state"])
    out = {k: payload[k] for k in _KEYS if k != "extras"}
    out["model"] = weights
    out.update(payload["extras"])
    return out


class NativeBackend:
    """The single-file backend (this module's functions)."""

    LAST_NAME = LAST_NAME
    BEST_NAME = BEST_NAME

    def save_checkpoint(self, path, model, state, extras, frozen_mask=None):
        save_checkpoint(path, model, state, extras, frozen_mask=frozen_mask)

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
        from openviic_tpu_torch.training.orbax_backend import OrbaxBackend

        return OrbaxBackend()
    if name == "native":
        return NativeBackend()
    raise ValueError(f"unknown checkpoint backend {name!r}")
