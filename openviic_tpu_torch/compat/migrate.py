"""A run of the original (PyTorch) OpenViIC -> the port's checkpoint (the
port's counterpart of ``openviic_tpu/compat/migrate.py``).

The original code keeps, per run directory (``trainers/base_trainer.py``
there):

 - ``best_model.pth`` / ``last_model.pth``: torch payloads with the model
   under ``state_dict``, the optimizer's and scheduler's states, RNG
   states and the trainer's ``epoch``, ``use_rl``, ``patience``,
   ``best_val_score`` and ``val_loss``;
 - ``vocab.bin``: its ``data_utils.vocab.Vocab`` pickled.

``import_reference_checkpoint`` turns such a run into the port's layout,
``best_model.ckpt`` (``training/checkpoint.py``'s format) and ``vocab.bin``,
which ``CaptioningPipeline(config, checkpoint_dir=...)``, the
``predict`` and ``serve`` CLIs and ``BaseTrainer`` (from a
``last_model.ckpt``) read.  The weights' names map through
``compat.torch_import``; the original's Adam moments become the port's
``torch.optim.Adam`` state, the Noam schedule's position carried.

The JAX module's ``dummy_batch`` is the fixed-shape batch that Flax's
``model.init`` traces to build a parameter template; the port's modules
hold their parameters from construction, so ``build_model`` stands in its
place."""

from __future__ import annotations

import collections
import os
import pickle
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from openviic_tpu_torch.compat.torch_import import convert_torch_state_dict
from openviic_tpu_torch.data.vocab import Vocab, _VocabUnpickler

# the attributes a usable Vocab carries (encode / decode and the trainer's)
_REQUIRED_VOCAB_ATTRS = ("itos", "stoi", "padding_idx", "bos_idx", "eos_idx", "unk_idx",
                         "padding_token", "bos_token", "eos_token", "unk_token",
                         "max_caption_length")

# the original's buffers among its state_dict keys (decode state, the
# classic positional table, the dead transformer's enc_output): every
# other key is a parameter, in ``model.parameters()`` order
_BUFFER_NAMES = frozenset({"running_keys", "running_values", "running_mask_self_attention",
                           "running_seq", "encoder_features", "encoder_padding_mask", "pe",
                           "enc_output"})


class _RefVocabStub:
    """Attribute bag standing in for the original's Vocab on unpickle."""


class _RefUnpickler(_VocabUnpickler):
    """The original's ``<package>.vocab.Vocab`` as a stub, the JAX
    package's and the port's as the port's ``Vocab``; besides them only
    the globals of torch, numpy and ``collections`` resolve (a tensor or
    an array of word vectors).  Those can reach ``torch.load``, so read
    only a run you trust."""

    def find_class(self, module: str, name: str):
        if (module, name) in self.ALLOWED:
            return self.ALLOWED[(module, name)]
        if name == "Vocab" and module.rsplit(".", 1)[-1] == "vocab":
            return _RefVocabStub
        if module.split(".")[0] in ("torch", "numpy", "_codecs", "collections"):
            return pickle.Unpickler.find_class(self, module, name)
        raise pickle.UnpicklingError(f"vocab pickle names a refused global {module}.{name}")


def load_reference_vocab(path: str) -> Vocab:
    """The original's ``vocab.bin`` (or a JAX or port one) as the port's
    ``Vocab``: the pickled instance's attributes copied onto a ``Vocab``
    made without scanning the caption files; torch tensors become numpy."""
    with open(path, "rb") as f:
        stub = _RefUnpickler(f).load()
    if isinstance(stub, Vocab):
        return stub
    if not isinstance(stub, _RefVocabStub):
        raise TypeError(f"{path} does not contain a Vocab (got {type(stub)!r})")
    vocab = object.__new__(Vocab)
    for key, value in vars(stub).items():
        setattr(vocab, key, value.detach().cpu().numpy() if torch.is_tensor(value) else value)
    for key in ("mapping", "word_embeddings", "tokenizer"):  # fields it may not have kept
        if not hasattr(vocab, key):
            setattr(vocab, key, None)
    if not hasattr(vocab, "freqs"):
        vocab.freqs = collections.Counter()
    if not hasattr(vocab, "specials"):
        vocab.specials = [vocab.padding_token, vocab.bos_token, vocab.eos_token, vocab.unk_token]
    missing = [a for a in _REQUIRED_VOCAB_ATTRS if not hasattr(vocab, a)]
    if missing:
        raise ValueError(f"reference vocab at {path} lacks required attributes: {missing}")
    return vocab


def convert_torch_adam_state(payload: Dict[str, Any], model: torch.nn.Module):
    """The original's Adam moments by the port's parameter names: (exp_avg,
    exp_avg_sq, step), two ``{name: tensor}`` and the largest step (the JAX
    package's one optax count), or None where the payload has none to use
    (none, empty, or not one parameter group).

    ``optimizer.state_dict()`` numbers the parameters in
    ``model.parameters()`` order, which is the original ``state_dict``'s
    keys less its buffers; the moments have their parameters' shapes, so
    they map as the weights do (``fc_gs`` clones stacked)."""
    opt_sd = payload.get("optimizer") or {}
    sd = payload.get("state_dict") or {}
    state, groups = opt_sd.get("state") or {}, opt_sd.get("param_groups") or []
    if not state or not sd or len(groups) != 1:
        return None
    names = [k for k in sd if k.rsplit(".", 1)[-1] not in _BUFFER_NAMES]
    avg, avg_sq, steps = {}, {}, []
    for idx, entry in state.items():
        idx = int(idx)
        if idx >= len(names) or "exp_avg" not in entry or "exp_avg_sq" not in entry:
            return None  # a layout this does not know: no guess
        avg[names[idx]], avg_sq[names[idx]] = entry["exp_avg"], entry["exp_avg_sq"]
        steps.append(int(torch.as_tensor(entry.get("step", 0)).item()))
    exp_avg, _, _ = convert_torch_state_dict(avg, model)
    exp_avg_sq, _, _ = convert_torch_state_dict(avg_sq, model)
    return exp_avg, exp_avg_sq, max(steps)


def _adam_with_moments(model, config, moments, step: int):
    """The trainer's XE Adam and Noam schedule for ``model`` (not a
    frozen-backbone model's), the schedule at ``step``, every parameter's
    state the original's moments (zero where it has none, as the JAX
    package's optax state) at ``step``."""
    from openviic_tpu_torch.training.optim import fast_forward_schedule, make_optimizer

    tr = config.TRAINING
    optimizer, scheduler = make_optimizer(model.parameters(), config.MODEL.ENCODER.D_MODEL,
                                          int(tr.get("WARMUP", 10000)),
                                          float(tr.get("LEARNING_RATE", 1.0)))
    fast_forward_schedule(optimizer, scheduler, step)
    exp_avg, exp_avg_sq, _ = moments
    for name, param in model.named_parameters():
        optimizer.state[param] = {
            "step": torch.tensor(float(step)),
            "exp_avg": exp_avg.get(name, torch.zeros_like(param)).to(param.device),
            "exp_avg_sq": exp_avg_sq.get(name, torch.zeros_like(param)).to(param.device),
        }
    return optimizer, scheduler


def import_reference_checkpoint(config, pth_path: str, out_dir: Optional[str] = None,
                                vocab: Optional[Vocab] = None, vocab_bin: Optional[str] = None,
                                write_last: bool = False, allow_missing: bool = False,
                                device="cuda") -> Dict[str, Any]:
    """Write the original run's ``pth_path`` as the port's
    ``<out_dir>/best_model.ckpt`` (and ``last_model.ckpt`` with
    ``write_last``, for ``BaseTrainer`` to resume) beside ``vocab.bin``;
    ``out_dir`` defaults to ``TRAINING.CHECKPOINT_PATH/MODEL.NAME``.  The
    model is built on ``device`` (the card unless the caller asks for the
    CPU).

    The vocab: ``vocab``, else ``vocab_bin`` (the original's pickle, or a
    JAX or port one), else the ``vocab.bin`` beside ``pth_path``, else
    built from ``config.DATASET``'s caption files.  A port parameter the
    checkpoint lacks, or an original key left unused, raises
    ``ValueError`` unless ``allow_missing`` (the missing parameters then
    keep the seed's random init).  The Adam moments of a payload that has
    them (a ``last_model.pth``) become the XE Adam's state and its step
    count the schedule's position; otherwise the schedule resumes at the
    original scheduler's count (``_step_count`` - 1) with fresh moments.
    ``epoch``, ``use_rl``, ``patience``, ``best_val_score`` and
    ``val_loss`` carry over, and so does the original's numpy RNG state.

    Returns a report: ``out_dir``, ``best``, ``missing``, ``unused``,
    ``step`` and the carried fields."""
    from openviic_tpu_torch.builders import build_model
    from openviic_tpu_torch.training import checkpoint as ckpt
    from openviic_tpu_torch.training.optim import frozen_param_mask
    from openviic_tpu_torch.utils import setup_logger

    logger = setup_logger()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("import_reference_checkpoint: no CUDA device; pass device='cpu'")
    payload = torch.load(pth_path, map_location="cpu", weights_only=False)
    if vocab is None:
        candidate = os.path.join(os.path.dirname(pth_path), "vocab.bin")
        vocab_bin = vocab_bin or (candidate if os.path.isfile(candidate) else None)
        if vocab_bin is not None:
            vocab = load_reference_vocab(vocab_bin)
            logger.info("Adopted vocab from %s (%d tokens)", vocab_bin, len(vocab))
        else:
            vocab = Vocab.from_config(config.DATASET)
            logger.info("Built vocab from the caption files (%d tokens)", len(vocab))

    model = build_model(config.MODEL, vocab, device=device)
    weights, missing, unused = convert_torch_state_dict(payload.get("state_dict", payload),
                                                        model)
    if (missing or unused) and not allow_missing:
        raise ValueError(
            f"reference checkpoint is missing weights for {len(missing)} params "
            f"{missing[:8]} and has {len(unused)} keys the model does not use {unused[:8]} "
            "(allow_missing keeps the missing ones at their random init)")
    model.load_state_dict(weights, strict=False)

    out_dir = out_dir or os.path.join(config.TRAINING.CHECKPOINT_PATH, config.MODEL.NAME)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "vocab.bin"), "wb") as f:
        pickle.dump(vocab, f)

    # the schedule's position: LambdaLR's _step_count starts at 1
    step = max(0, int((payload.get("scheduler") or {}).get("_step_count", 1)) - 1)
    optimizer = scheduler = None
    moments = convert_torch_adam_state(payload, model)
    if moments is not None and frozen_param_mask(model) is None:
        step = moments[2]  # the optimizer's count over the scheduler's
        optimizer, scheduler = _adam_with_moments(model, config, moments, step)
        logger.info("Carried Adam moments across (%d optimizer steps)", step)

    extras = {k: payload[k] for k in ("epoch", "use_rl", "patience", "best_val_score",
                                      "val_loss") if k in payload}
    state = {"optimizer": optimizer, "scheduler": scheduler, "step": step,
             "generator": torch.Generator().manual_seed(0)}
    rng_state = payload.get("numpy_rng_state")
    saved_rng = np.random.get_state()
    best = os.path.join(out_dir, ckpt.BEST_NAME)
    try:  # the checkpoint keeps the numpy state current when it is written
        if rng_state is not None:
            np.random.set_state(rng_state)
        ckpt.save_checkpoint(best, model, state, extras)
    finally:
        np.random.set_state(saved_rng)
    if write_last:
        shutil.copyfile(best, os.path.join(out_dir, ckpt.LAST_NAME))
    logger.info("Imported %s -> %s (epoch %s, step %d, %d reference keys unused)", pth_path,
                best, extras.get("epoch"), step, len(unused))
    return {"out_dir": out_dir, "best": best, "missing": missing, "unused": unused,
            "step": step, **extras}
