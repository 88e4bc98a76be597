"""Caption datasets: the part of ``openviic_tpu/data/datasets.py`` that
builds one teacher-forcing sample (``FeatureDataset.__getitem__``).  The
datasets over feature directories are not ported yet."""

from __future__ import annotations

from typing import List

import numpy as np

from openviic_tpu_torch.data.instance import Instance


def caption_instance(vocab, caption: List[str], **features) -> Instance:
    """One sample of a preprocessed caption: ``caption_tokens``, the encoded
    caption with its eos replaced by pad (the decoder input), and
    ``shifted_right_caption_tokens``, the encoded caption shifted one step
    left and padded (the target), with the image's ``features``."""
    encoded = vocab.encode_caption(caption)
    shifted = np.full_like(encoded, vocab.padding_idx)
    shifted[:-1] = encoded[1:]
    tokens = np.where(encoded == vocab.eos_idx, vocab.padding_idx, encoded)
    return Instance(caption_tokens=tokens.astype(np.int32),
                    shifted_right_caption_tokens=shifted.astype(np.int32), **features)
