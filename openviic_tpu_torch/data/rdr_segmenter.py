"""ctypes binding of the native Vietnamese word segmenter (the port's
counterpart of ``openviic_tpu/data/rdr_segmenter.py``), the tokenizer
``rdr`` of ``data/preprocess.py``.

The engine is ``native/rdr_segmenter.cpp``: lexicon longest matching, then
the JOIN / SPLIT correction rules, or, with an SCRDR model (VnCoreNLP's
``wordsegmenter.rdr`` tree format), B/I tagging corrected by the tree.
The library is the committed ``native/librdr_segmenter.so``; where it is
missing or does not load, the port compiles its own copy from the source
with ``g++`` into ``openviic_tpu_torch/_build/`` (named by the source's
hash, as ``openviic_tpu_torch/native`` builds the scorers; nothing is
written into ``native/``).  Where neither loads, ``RDRSegmenter`` raises
``RuntimeError``: the JAX package's ``pyvi`` fallback is a package the
port does not use.

The lexicon, rules and model paths come from the constructor or the
``OPENVIIC_RDR_LEXICON``, ``OPENVIIC_RDR_RULES`` and ``OPENVIIC_RDR_MODEL``
environment variables; a path that is not a file is skipped, as in the
JAX package.  Nothing here runs at import."""

from __future__ import annotations

import ctypes
import logging
import os
from pathlib import Path
from typing import Optional

from openviic_tpu_torch import native

logger = logging.getLogger(__name__)

SOURCE = native.SOURCE.parent / "rdr_segmenter.cpp"
COMMITTED = native.SOURCE.parent / "librdr_segmenter.so"
BUILD_DIR = native.BUILD_DIR

_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[Path] = None
_tried = False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.rdr_new.restype = ctypes.c_void_p
    lib.rdr_delete.argtypes = [ctypes.c_void_p]
    for name in ("rdr_load_lexicon", "rdr_load_rules", "rdr_add_word", "rdr_load_scrdr"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        getattr(lib, name).restype = ctypes.c_int
    lib.rdr_segment.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rdr_segment.restype = ctypes.c_void_p  # malloc'd, freed with libc's free
    return lib


def _open(path: Path) -> Optional[ctypes.CDLL]:
    try:
        return _bind(ctypes.CDLL(str(path)))
    except (OSError, AttributeError) as exc:
        logger.warning("rdr segmenter: %s does not load (%s)", path, exc)
        return None


def _load() -> Optional[ctypes.CDLL]:
    """The bound library: the committed one, else the port's own build;
    None when neither loads.  Tried once per process."""
    global _lib, _lib_path, _tried
    if not _tried:
        _tried = True
        path = COMMITTED
        lib = _open(path) if path.is_file() else None
        if lib is None:
            path = native.build_shared(SOURCE, "rdr_segmenter", BUILD_DIR)
            lib = _open(path) if path is not None else None
        if lib is not None:
            _lib, _lib_path = lib, path
            logger.info("rdr segmenter: loaded %s", path)
    return _lib


def library_path() -> Optional[Path]:
    """The path of the loaded library (None when none loads)."""
    _load()
    return _lib_path


def _free(pointer: int) -> None:
    """libc's ``free`` of a buffer the library returned."""
    free = ctypes.CDLL(None).free
    free.argtypes = [ctypes.c_void_p]
    free(pointer)


class RDRSegmenter:
    """One native segmenter (its lexicon, rules and SCRDR tree)."""

    _default: Optional["RDRSegmenter"] = None

    def __init__(self, lexicon_path: Optional[str] = None, rules_path: Optional[str] = None,
                 model_path: Optional[str] = None):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                f"no native segmenter loads: neither {COMMITTED} nor a g++ build of {SOURCE} "
                f"(the JAX package's pyvi fallback is not used by the port)")
        self._lib = lib
        self._handle = lib.rdr_new()
        lexicon_path = lexicon_path or os.environ.get("OPENVIIC_RDR_LEXICON")
        rules_path = rules_path or os.environ.get("OPENVIIC_RDR_RULES")
        model_path = model_path or os.environ.get("OPENVIIC_RDR_MODEL")
        if lexicon_path and os.path.isfile(lexicon_path):
            lib.rdr_load_lexicon(self._handle, lexicon_path.encode())
        if rules_path and os.path.isfile(rules_path):
            lib.rdr_load_rules(self._handle, rules_path.encode())
        if model_path and os.path.isfile(model_path):
            self.load_scrdr(model_path)

    def add_word(self, word: str) -> None:
        """Add a multi-syllable word (``"học sinh"``) to the lexicon."""
        self._lib.rdr_add_word(self._handle, word.encode())

    def load_scrdr(self, model_path: str) -> int:
        """Load an SCRDR tree model (VnCoreNLP's ``.rdr`` format: tab-indented
        ``condition : object.conclusion = "B|I"`` lines); returns its node
        count, ``ValueError`` when it does not parse."""
        n = self._lib.rdr_load_scrdr(self._handle, model_path.encode())
        if n < 0:
            raise ValueError(f"failed to parse SCRDR model at {model_path}")
        return n

    def tokenize(self, sentence: str) -> str:
        """The sentence's words joined by spaces, a word's syllables by ``_``."""
        raw = self._lib.rdr_segment(self._handle, sentence.encode())
        try:
            return ctypes.string_at(raw).decode()
        finally:
            _free(raw)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.rdr_delete(self._handle)
            self._handle = None

    @classmethod
    def default(cls) -> "RDRSegmenter":
        """The process's segmenter from the environment variables, made at
        first use."""
        if cls._default is None:
            cls._default = cls()
        return cls._default
