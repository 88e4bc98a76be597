"""Builder registries, one per module kind (the port's counterpart of
``openviic_tpu/builders.py``).

The registries are the port's own instances: the torch classes register
under the same ``ARCHITECTURE:`` names the JAX package uses, so both read
the same config tree."""

from __future__ import annotations

import torch

from openviic_tpu_torch.registry import Registry

META_TRAINER = Registry("TRAINER")
META_ARCHITECTURE = Registry("ARCHITECTURE")
META_ENCODER = Registry("ENCODER")
META_DECODER = Registry("DECODER")
META_ATTENTION = Registry("ATTENTION")
META_TEXT_EMBEDDING = Registry("TEXT_EMBEDDING")
META_VISION_EMBEDDING = Registry("VISION_EMBEDDING")
META_PRETRAINED_LANGUAGE_MODEL = Registry("PRETRAINED_LANGUAGE_MODEL")
META_WORD_EMBEDDING = Registry("WORD_EMBEDDING")

# Aliases resolving names and a typo shipped in the reference's configs.
META_TRAINER.alias("ViTrainer", "viTrainer")
META_TRAINER.alias("EnTrainer", "enTrainer")
META_ARCHITECTURE.alias(
    "StandardStranformerUsingRegion", "StandardTransformerUsingRegion"
)


def _ensure_registered() -> None:
    """Import the module zoo so registration decorators have run (lazy to
    avoid a circular import: the models import the registries above)."""
    import openviic_tpu_torch.models  # noqa: F401


def build_trainer(config, device="cuda"):
    """The trainer named by ``config.TRAINER`` (``viTrainer``,
    ``enTrainer``), on ``device``."""
    _ensure_registered()
    import openviic_tpu_torch.training.trainer  # noqa: F401  (registers the trainers)

    return META_TRAINER.get(config.TRAINER)(config, device=device)


def build_model(config, vocab, device="cuda", seed: int = 0, init: bool = True):
    """Build the architecture named by ``config.ARCHITECTURE``.

    Parameters are initialised on the CPU from ``torch.Generator(seed)``
    (the JAX package's init schemes), then moved to ``device``; with
    ``init=False`` every random draw is skipped, the layers' constructors'
    too (``without_default_init``), for a caller that loads every parameter
    next.  The model is returned in eval mode, the JAX package's
    ``train=False`` default."""
    from openviic_tpu_torch.models.initializers import initialize, without_default_init

    _ensure_registered()
    model_cls = META_ARCHITECTURE.get(config.ARCHITECTURE)
    if init:
        model = model_cls(config=config, vocab=vocab)
        initialize(model, torch.Generator().manual_seed(seed))
    else:
        with without_default_init():
            model = model_cls(config=config, vocab=vocab)
    return model.to(device).eval()


def build_encoder(config):
    return META_ENCODER.get(config.ARCHITECTURE)(config=config)


def build_decoder(config, vocab):
    return META_DECODER.get(config.ARCHITECTURE)(config=config, vocab=vocab)


def build_attention(config):
    return META_ATTENTION.get(config.ARCHITECTURE)(config=config)


def build_text_embedding(config, vocab):
    return META_TEXT_EMBEDDING.get(config.ARCHITECTURE)(config=config, vocab=vocab)


def build_vision_embedding(config):
    return META_VISION_EMBEDDING.get(config.ARCHITECTURE)(config=config)


def build_pretrained_language_model(config):
    return META_PRETRAINED_LANGUAGE_MODEL.get(config.ARCHITECTURE)(config=config)


def build_word_embedding(config):
    """The pretrained vectors named by ``config.WORD_EMBEDDING`` (a name,
    or a list of names for a list of them), read from
    ``WORD_EMBEDDING_CACHE``; None when it is None."""
    import openviic_tpu_torch.data.word_embedding  # noqa: F401  (registers the classes)

    name = config.WORD_EMBEDDING
    if name is None:
        return None
    cache = config.get("WORD_EMBEDDING_CACHE")
    if isinstance(name, (list, tuple)):
        return [META_WORD_EMBEDDING.get(n)(cache=cache) for n in name]
    return META_WORD_EMBEDDING.get(name)(cache=cache)
