"""Token vocabulary: the attributes the models and decoders consume.

The port's own counterpart of ``openviic_tpu/data/vocab.py``: it is built
from an id -> token list (``itos``) or read from the JAX package's pickled
``vocab.bin`` (``load_vocab``), and keeps that module's id conventions
(specials ``<pad> <bos> <eos> <unk>`` first) and its ``encode_caption`` and
``decode_caption`` semantics.  Building a vocab from caption files is not
ported yet."""

from __future__ import annotations

import collections
import pickle
from typing import Dict, List, Sequence

import numpy as np

SPECIALS = ("<pad>", "<bos>", "<eos>", "<unk>")


class Vocab:
    """Unpickling sets the JAX package's attributes (``itos``, ``stoi``,
    ``specials``, the special ids, ``max_caption_length``, ``freqs`` and
    more) on an instance without calling ``__init__``; every method reads
    only those."""

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

    def encode_caption(self, caption: List[str]) -> np.ndarray:
        """Caption tokens -> fixed-length padded id vector (int32): bos, the
        tokens (unknown ones as unk), eos, then pad.  A caption longer than
        ``max_caption_length - 2`` raises, as in the JAX package."""
        vec = np.full((self.max_caption_length,), self.padding_idx, dtype=np.int32)
        ids = [self.stoi[tok] if tok in self.stoi else self.unk_idx for tok in caption]
        for i, idx in enumerate([self.bos_idx] + ids + [self.eos_idx]):
            vec[i] = idx
        return vec

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


class _VocabUnpickler(pickle.Unpickler):
    """Reads the JAX package's pickled ``Vocab`` as the port's, and refuses
    every global besides the two containers it holds."""

    ALLOWED = {("openviic_tpu.data.vocab", "Vocab"): Vocab,
               ("collections", "Counter"): collections.Counter,
               ("collections", "defaultdict"): collections.defaultdict}

    def find_class(self, module: str, name: str):
        if (module, name) in self.ALLOWED:
            return self.ALLOWED[(module, name)]
        raise pickle.UnpicklingError(f"vocab pickle names a refused global {module}.{name}")


def load_vocab(path) -> Vocab:
    """The vocab pickled at ``path`` (the JAX package's ``vocab.bin``),
    without importing the JAX package."""
    with open(path, "rb") as f:
        vocab = _VocabUnpickler(f).load()
    if not isinstance(vocab, Vocab):
        raise pickle.UnpicklingError(f"{path} holds a {type(vocab).__name__}, not a Vocab")
    return vocab
