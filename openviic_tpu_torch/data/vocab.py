"""Token vocabulary: the attributes the models and decoders consume.

The port's own minimal counterpart of ``openviic_tpu/data/vocab.py``: it is
built from an id -> token list (``itos``) and keeps that module's id
conventions (specials ``<pad> <bos> <eos> <unk>`` first) and its
``decode_caption`` semantics.  Building a vocab from caption files, and
reading the JAX package's pickled ``vocab.bin``, are not ported yet."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

SPECIALS = ("<pad>", "<bos>", "<eos>", "<unk>")


class Vocab:
    def __init__(self, itos: Sequence[str], max_caption_length: int,
                 specials: Sequence[str] = SPECIALS):
        self.itos: List[str] = list(itos)
        self.stoi: Dict[str, int] = {tok: i for i, tok in enumerate(self.itos)}
        if len(self.stoi) != len(self.itos):
            raise ValueError("vocab tokens must be unique")
        self.specials = list(specials)
        pad, bos, eos, unk = self.specials
        self.padding_idx = self.stoi[pad]
        self.bos_idx = self.stoi[bos]
        self.eos_idx = self.stoi[eos]
        self.unk_idx = self.stoi[unk]
        self.max_caption_length = int(max_caption_length)

    def decode_caption(self, caption_vecs, join_words: bool = True):
        """Id matrix (bs, max_len) -> list of caption strings (or word lists).

        Drops special tokens and stops at ``<eos>`` (specials inside the
        caption are dropped; the loop breaks only on eos)."""
        specials = set(self.specials)
        captions = []
        for vec in np.asarray(caption_vecs):
            words = []
            for idx in vec.tolist():
                if self.itos[idx] not in specials:
                    words.append(self.itos[idx])
                if idx == self.eos_idx:
                    break
            caption = " ".join(words)
            captions.append(caption if join_words else caption.split())
        return captions

    def __len__(self) -> int:
        return len(self.itos)
