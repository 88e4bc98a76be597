"""Pretrained word vectors (PhoW2V, fastText): the port's counterpart of
``openviic_tpu/data/word_embedding.py``.

A ``WordEmbedding`` reads GloVe-format text (one ``<word> <v_1> ... <v_dim>``
line a word; fastText's ``<count> <dim>`` header line is recognised and
sets ``dim``; ``.gz`` files are read compressed) from its cache directory
(``WORD_EMBEDDING_CACHE``, default ``~/.cache/openviic_tpu/vectors``, the
JAX package's) and keeps it there as ``<filename>.npz`` (``vectors``
float32, ``itos`` an object array), which a later instance reads instead.
The ``.npz`` has the JAX module's keys, so either package reads a cache
that the other wrote.  A word seen twice keeps its first vector.  A token
without a vector gets ``unk_init``'s deterministic row: 0 for pad, 1 for
bos, 2 for eos, 3 for any other.

The vector files are the users' to supply: place one at
``<cache>/<filename>``.  On a cache miss a class with a ``url`` downloads
it there first, as the JAX module does; a ``.zip`` archive is saved as
``<filename>.zip`` and extracted beside it (the JAX module saves it under
the vector file's own name, unextracted, and then fails to parse it).
Without a URL, or when the download fails, a ``FileNotFoundError`` names
where to put the file.  Registered names: ``PhoW2VSyllable100``,
``PhoW2VSyllable300``, ``PhoW2VWord100``, ``PhoW2VWord300``,
``EnFastText``, ``ViFastText``."""

from __future__ import annotations

import gzip
import os
import zipfile
from typing import Dict, Optional

import numpy as np

from openviic_tpu_torch.builders import META_WORD_EMBEDDING
from openviic_tpu_torch.utils import setup_logger

logger = setup_logger()

DEFAULT_CACHE = os.path.join("~", ".cache", "openviic_tpu", "vectors")


def unk_init(token: str, dim: int) -> np.ndarray:
    if token in ("<pad>", "<p>"):
        return np.zeros(dim, np.float32)
    if token in ("<sos>", "<bos>", "<s>"):
        return np.ones(dim, np.float32)
    if token in ("<eos>", "</s>"):
        return np.full(dim, 2.0, np.float32)
    return np.full(dim, 3.0, np.float32)


class WordEmbedding:
    """GloVe-format text vectors with an ``.npz`` binary cache."""

    url: Optional[str] = None
    filename: Optional[str] = None
    dim: int = 300

    def __init__(self, cache: Optional[str] = None):
        self.cache_dir = cache or os.path.expanduser(DEFAULT_CACHE)
        self.stoi: Dict[str, int] = {}
        self.vectors: Optional[np.ndarray] = None
        self._load()

    def _cache_file(self) -> str:
        return os.path.join(self.cache_dir, f"{self.filename}.npz")

    def _source_file(self) -> str:
        return os.path.join(self.cache_dir, self.filename)

    def _load(self) -> None:
        cache_file = self._cache_file()
        if os.path.isfile(cache_file):
            with np.load(cache_file, allow_pickle=True) as data:
                self.vectors = data["vectors"].astype(np.float32)
                itos = list(data["itos"])
            self.stoi = {tok: i for i, tok in enumerate(itos)}
            return
        source = self._source_file()
        if not os.path.isfile(source):
            self._download(source)
        self._parse(source)
        os.makedirs(self.cache_dir, exist_ok=True)
        itos = [None] * len(self.stoi)
        for tok, i in self.stoi.items():
            itos[i] = tok
        np.savez_compressed(cache_file, vectors=self.vectors, itos=np.asarray(itos, object))

    def _download(self, dest: str) -> None:
        if self.url is None:
            raise FileNotFoundError(f"No cached vectors at {dest} and no source URL for "
                                    f"{type(self).__name__}")
        import urllib.request

        os.makedirs(os.path.dirname(dest), exist_ok=True)
        # a zip archive is fetched beside the vector file and extracted (the
        # JAX module writes it under the vector file's own name, unextracted)
        archive = dest + ".zip" if self.url.endswith(".zip") and not dest.endswith(".zip") \
            else dest
        logger.info("Downloading %s -> %s", self.url, archive)
        try:
            urllib.request.urlretrieve(self.url, archive)
        except Exception as e:
            raise FileNotFoundError(f"Could not download {self.url} ({e}).  Place the vector "
                                    f"file at {dest} manually (offline environment).") from e
        if archive.endswith(".zip"):
            with zipfile.ZipFile(archive) as zf:
                zf.extractall(os.path.dirname(dest))
        if not os.path.isfile(dest):
            raise FileNotFoundError(f"{self.url} holds no {os.path.basename(dest)}.  Place the "
                                    f"vector file at {dest} manually.")

    def _parse(self, path: str) -> None:
        opener = gzip.open if path.endswith(".gz") else open
        vectors = []
        with opener(path, "rt", encoding="utf-8", errors="replace") as f:
            parts = f.readline().rstrip().split(" ")
            if len(parts) == 2 and parts[0].isdigit():  # fastText: "<count> <dim>"
                self.dim = int(parts[1])
            else:
                self._add_line(parts, vectors)
            for line in f:
                self._add_line(line.rstrip().split(" "), vectors)
        self.vectors = np.asarray(vectors, np.float32)

    def _add_line(self, parts, vectors) -> None:
        word = " ".join(parts[: len(parts) - self.dim])
        if word in self.stoi:
            return
        self.stoi[word] = len(vectors)
        vectors.append([float(x) for x in parts[len(parts) - self.dim:]])

    def __getitem__(self, token: str) -> np.ndarray:
        idx = self.stoi.get(token)
        if idx is None:
            return unk_init(token, self.dim)
        return self.vectors[idx]

    def __contains__(self, token: str) -> bool:
        return token in self.stoi

    def __len__(self) -> int:
        return len(self.stoi)


@META_WORD_EMBEDDING.register()
class PhoW2VSyllable100(WordEmbedding):
    url = "https://public.vinai.io/word2vec_vi_syllables_100dims.zip"
    filename = "word2vec_vi_syllables_100dims.txt"
    dim = 100


@META_WORD_EMBEDDING.register()
class PhoW2VSyllable300(WordEmbedding):
    url = "https://public.vinai.io/word2vec_vi_syllables_300dims.zip"
    filename = "word2vec_vi_syllables_300dims.txt"
    dim = 300


@META_WORD_EMBEDDING.register()
class PhoW2VWord100(WordEmbedding):
    url = "https://public.vinai.io/word2vec_vi_words_100dims.zip"
    filename = "word2vec_vi_words_100dims.txt"
    dim = 100


@META_WORD_EMBEDDING.register()
class PhoW2VWord300(WordEmbedding):
    url = "https://public.vinai.io/word2vec_vi_words_300dims.zip"
    filename = "word2vec_vi_words_300dims.txt"
    dim = 300


@META_WORD_EMBEDDING.register()
class EnFastText(WordEmbedding):
    url = "https://dl.fbaipublicfiles.com/fasttext/vectors-english/wiki-news-300d-1M.vec.zip"
    filename = "wiki-news-300d-1M.vec"
    dim = 300


@META_WORD_EMBEDDING.register()
class ViFastText(WordEmbedding):
    url = "https://dl.fbaipublicfiles.com/fasttext/vectors-crawl/cc.vi.300.vec.gz"
    filename = "cc.vi.300.vec.gz"
    dim = 300
