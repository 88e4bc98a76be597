"""Token vocabulary (the port's counterpart of ``openviic_tpu/data/vocab.py``).

A vocab is built from a ``DATASET`` config (``Vocab.from_config``, the JAX
``Vocab(config)``), from an id -> token list (``itos``), or read from a
pickle (``load_vocab``: the JAX package's ``vocab.bin`` or the port's own).
The JAX module's conventions are kept:

 - built by scanning the train, dev **and** test caption files (the
   reference's leakage of the test split, kept for parity);
 - sorted by frequency, ties alphabetically; words below ``MIN_FREQ`` left
   out;
 - the specials from ``VOCAB.PAD_TOKEN``, ``BOS_TOKEN``, ``EOS_TOKEN`` and
   ``UNK_TOKEN`` occupy the first ids, in that order;
 - ``max_caption_length`` is the longest preprocessed caption + 2;
 - ``encode_caption`` and ``decode_caption`` as there.

``VOCAB.WORD_EMBEDDING`` (a name or a list of names of
``data/word_embedding.py``, read from ``VOCAB.WORD_EMBEDDING_CACHE``) fills
``word_embeddings``, the (vocab, dim) float32 vectors of every token, the
names' vectors side by side (``load_word_embeddings``).
``VOCAB.USE_MAPPING`` and ``PRETRAINED_LANGUAGE_MODEL`` need a
``transformers`` tokenizer and raise ``NotImplementedError``."""

from __future__ import annotations

import collections
import json
import pickle
from typing import Dict, List, Sequence

import numpy as np

from openviic_tpu_torch.data.preprocess import preprocess_caption

SPECIALS = ("<pad>", "<bos>", "<eos>", "<unk>")


class Vocab:
    """Unpickling sets the JAX package's attributes (``itos``, ``stoi``,
    ``specials``, the special ids, ``max_caption_length``, ``freqs``,
    ``tokenizer`` and more) on an instance without calling ``__init__``;
    every method reads only those."""

    def __init__(self, itos: Sequence[str], max_caption_length: int,
                 specials: Sequence[str] = SPECIALS, freqs=None, tokenizer=None):
        self.itos: List[str] = list(itos)
        self.stoi: Dict[str, int] = {tok: i for i, tok in enumerate(self.itos)}
        if len(self.stoi) != len(self.itos):
            raise ValueError("vocab tokens must be unique")
        self.specials = list(specials)
        (self.padding_token, self.bos_token, self.eos_token,
         self.unk_token) = self.specials
        self.padding_idx = self.stoi[self.padding_token]
        self.bos_idx = self.stoi[self.bos_token]
        self.eos_idx = self.stoi[self.eos_token]
        self.unk_idx = self.stoi[self.unk_token]
        self.max_caption_length = int(max_caption_length)
        self.freqs = collections.Counter() if freqs is None else freqs
        self.tokenizer = tokenizer
        self.mapping = None
        self.word_embeddings = None

    @classmethod
    def from_config(cls, config) -> "Vocab":
        """The vocab of a ``DATASET`` config: its train, dev and test
        caption files scanned (``make_vocab``), the specials first, then
        every word of at least ``MIN_FREQ`` occurrences by frequency, ties
        alphabetically."""
        voc = config.VOCAB
        for key in ("PRETRAINED_LANGUAGE_MODEL", "USE_MAPPING"):
            if voc.get(key):
                raise NotImplementedError(
                    f"DATASET.VOCAB.{key} needs a transformers tokenizer and is not ported")
        specials = [voc.PAD_TOKEN, voc.BOS_TOKEN, voc.EOS_TOKEN, voc.UNK_TOKEN]
        freqs, max_len = make_vocab(
            [config.JSON_PATH.TRAIN, config.JSON_PATH.DEV, config.JSON_PATH.TEST],
            voc.TOKENIZER)
        counter = freqs.copy()
        for tok in specials:
            counter.pop(tok, None)
        min_freq = max(config.MIN_FREQ, 1)
        # by frequency, ties alphabetically (two stable sorts, as the JAX module)
        words = sorted(counter.items(), key=lambda tup: tup[0])
        words.sort(key=lambda tup: tup[1], reverse=True)
        itos = list(specials)
        for word, freq in words:
            if freq < min_freq:
                break
            itos.append(word)
        vocab = cls(itos, max_len, specials, freqs=freqs, tokenizer=voc.TOKENIZER)
        if voc.get("WORD_EMBEDDING") is not None:
            from openviic_tpu_torch.builders import build_word_embedding

            vocab.load_word_embeddings(build_word_embedding(voc))
        return vocab

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

    def load_word_embeddings(self, word_embeddings) -> None:
        """Set ``word_embeddings`` to each token's vectors from
        ``word_embeddings`` (a ``WordEmbedding`` or a list of them, side by
        side), the token stripped of surrounding blanks; a token without a
        vector gets ``unk_init``'s row."""
        if not isinstance(word_embeddings, list):
            word_embeddings = [word_embeddings]
        total = sum(v.dim for v in word_embeddings)
        self.word_embeddings = np.zeros((len(self), total), dtype=np.float32)
        for i, token in enumerate(self.itos):
            start = 0
            for v in word_embeddings:
                self.word_embeddings[i, start:start + v.dim] = v[token.strip()]
                start += v.dim

    def extend(self, v: "Vocab", sort: bool = False) -> None:
        """Append ``v``'s words that this vocab lacks (sorted, with ``sort``)."""
        for w in (sorted(v.itos) if sort else v.itos):
            if w not in self.stoi:
                self.itos.append(w)
                self.stoi[w] = len(self.itos) - 1

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Vocab):
            return NotImplemented
        return (self.freqs == other.freqs and dict(self.stoi) == dict(other.stoi)
                and self.itos == other.itos)

    def __len__(self) -> int:
        return len(self.itos)


def make_vocab(json_paths: Sequence[str], tokenizer=None):
    """(word frequencies, the longest caption + 2) over the annotations of
    the caption files ``json_paths``, each caption preprocessed."""
    freqs: collections.Counter = collections.Counter()
    max_len = 0
    for path in json_paths:
        with open(path) as f:
            annotations = json.load(f)["annotations"]
        for ann in annotations:
            caption = preprocess_caption(ann["caption"], tokenizer)
            freqs.update(caption)
            max_len = max(max_len, len(caption) + 2)
    return freqs, max_len


def _numpy_globals() -> dict:
    """The globals a pickled ndarray names (its class, its dtype and the
    function that rebuilds it, under numpy 1's and numpy 2's module paths;
    ``_codecs.encode``, which rebuilds its bytes in a protocol-2 pickle)."""
    import codecs
    import importlib

    try:  # numpy 2's path; numpy 1 has only numpy.core
        multiarray = importlib.import_module("numpy._core.multiarray")
        numeric = importlib.import_module("numpy._core.numeric")
    except ImportError:
        multiarray = importlib.import_module("numpy.core.multiarray")
        numeric = importlib.import_module("numpy.core.numeric")
    out = {("numpy", "ndarray"): np.ndarray, ("numpy", "dtype"): np.dtype,
           ("_codecs", "encode"): codecs.encode}
    for path in ("numpy.core", "numpy._core"):  # a pickle of either numpy
        out[(f"{path}.multiarray", "_reconstruct")] = multiarray._reconstruct
        out[(f"{path}.numeric", "_frombuffer")] = numeric._frombuffer
    return out


class _VocabUnpickler(pickle.Unpickler):
    """Reads the JAX package's pickled ``Vocab`` as the port's, and the
    port's own, and refuses every global besides the two containers they
    hold and the numpy globals of their ``word_embeddings`` array."""

    ALLOWED = {("openviic_tpu.data.vocab", "Vocab"): Vocab,
               ("openviic_tpu_torch.data.vocab", "Vocab"): Vocab,
               ("collections", "Counter"): collections.Counter,
               ("collections", "defaultdict"): collections.defaultdict}
    ALLOWED_ARRAY = _numpy_globals()

    def find_class(self, module: str, name: str):
        if (module, name) in self.ALLOWED:
            return self.ALLOWED[(module, name)]
        if (module, name) in self.ALLOWED_ARRAY:
            return self.ALLOWED_ARRAY[(module, name)]
        raise pickle.UnpicklingError(f"vocab pickle names a refused global {module}.{name}")


def load_vocab(path) -> Vocab:
    """The vocab pickled at ``path`` (the JAX package's ``vocab.bin`` or
    the port's own), without importing the JAX package."""
    with open(path, "rb") as f:
        vocab = _VocabUnpickler(f).load()
    if not isinstance(vocab, Vocab):
        raise pickle.UnpicklingError(f"{path} holds a {type(vocab).__name__}, not a Vocab")
    vectors = getattr(vocab, "word_embeddings", None)
    if vectors is not None and not (isinstance(vectors, np.ndarray)
                                    and vectors.dtype == np.float32 and vectors.ndim == 2):
        raise pickle.UnpicklingError(f"{path}: word_embeddings is not a float32 matrix")
    return vocab
