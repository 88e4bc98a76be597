"""ctypes binding of the native C++ scorers and tokenizer (the port's
counterpart of ``openviic_tpu/native/__init__.py``).

The library is the committed ``native/libopenviic_native.so``, built from
``native/openviic_native.cpp``: CIDEr (with precomputed train document
frequencies, for the SCST reward), classic METEOR, METEOR 1.5 and the PTB
tokenizer, each equal to its Python scorer in ``evaluation/`` (within
1e-9).  Where the committed library is missing or does not load (an
``OSError`` from ``ctypes.CDLL``, such as a host whose C++ runtime is older
than the GLIBC_2.29 / GLIBCXX_3.4.29 it needs), the port compiles its own
copy from that source with ``g++`` into ``openviic_tpu_torch/_build/``,
named by the source's hash; it never writes into ``native/``.  When neither
loads, ``available()`` is false and callers use the Python scorers.

Records are joined by ``\\x1e`` and the references of one record by
``\\x1f``, as the library reads them.  Nothing here runs at import."""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _REPO_ROOT / "native" / "openviic_native.cpp"
COMMITTED = _REPO_ROOT / "native" / "libopenviic_native.so"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")  # native/build.sh's
GXX_TIMEOUT_S = 300

_RS = "\x1e"  # record separator
_FS = "\x1f"  # field separator (refs within a record)

_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[Path] = None
_tried = False


def shared_path(source: Path, stem: str, build_dir: Path) -> Path:
    """Where the port's own build of ``source`` goes: ``build_dir`` /
    ``<stem>-<hash of the source and the flags>.so``."""
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return build_dir / f"{stem}-{digest.hexdigest()[:16]}.so"


def build_shared(source: Path, stem: str, build_dir: Path) -> Optional[Path]:
    """Compile ``source`` into ``shared_path(...)`` unless it is there; None
    when there is no source or no compiler, or the compile fails."""
    out = shared_path(source, stem, build_dir) if source.is_file() else None
    if out is None or out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        logger.warning("native: no g++ to build %s", source)
        return None
    build_dir.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True, timeout=GXX_TIMEOUT_S)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        logger.warning("native: g++ failed on %s:\n%s", source, proc.stderr[-2000:])
        return None
    os.replace(tmp, out)  # atomic: concurrent builds leave one whole library
    return out


def built_path() -> Path:
    """Where the port's own build of ``SOURCE`` goes."""
    return shared_path(SOURCE, "openviic_native", BUILD_DIR)


def _build() -> Optional[Path]:
    return build_shared(SOURCE, "openviic_native", BUILD_DIR)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ov_free.argtypes = [ctypes.c_void_p]
    lib.ov_cider_new.argtypes = [ctypes.c_char_p]
    lib.ov_cider_new.restype = ctypes.c_void_p
    lib.ov_cider_delete.argtypes = [ctypes.c_void_p]
    lib.ov_cider_score.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p]
    lib.ov_cider_score.restype = ctypes.POINTER(ctypes.c_double)
    lib.ov_meteor_score.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.ov_meteor_score.restype = ctypes.POINTER(ctypes.c_double)
    # the METEOR 1.5 stages came in three library versions: a stale library
    # lacks the later entry points, and the scorers check for them
    meteor15 = {"ov_meteor15_score": 3, "ov_meteor15_score_syn": 4, "ov_meteor15_score_par": 5}
    for name, n_args in meteor15.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_char_p] * n_args
            fn.restype = ctypes.POINTER(ctypes.c_double)
    lib.ov_ptb_tokenize.argtypes = [ctypes.c_char_p]
    lib.ov_ptb_tokenize.restype = ctypes.c_void_p  # freed with ov_free
    return lib


def _open(path: Path) -> Optional[ctypes.CDLL]:
    try:
        return _bind(ctypes.CDLL(str(path)))
    except OSError as exc:
        logger.warning("native scorers: %s does not load (%s)", path, exc)
        return None


def _load() -> Optional[ctypes.CDLL]:
    """The bound library: the committed one, else the port's own build;
    None when neither loads.  Tried once per process; logs which loaded."""
    global _lib, _lib_path, _tried
    if not _tried:
        _tried = True
        path = COMMITTED
        lib = _open(path) if path.is_file() else None
        if lib is None:
            path = _build()
            lib = _open(path) if path is not None else None
        if lib is None:
            logger.warning("native scorers: no library loads; the Python scorers run")
        else:
            _lib, _lib_path = lib, path
            logger.info("native scorers: loaded %s", path)
    return _lib


def available() -> bool:
    return _load() is not None


def library_path() -> Optional[Path]:
    """The path of the loaded library (None when none loads)."""
    _load()
    return _lib_path


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def _as_text(x) -> str:
    if isinstance(x, (list, tuple)):
        return " ".join(x)
    return x


def _encode_pairs(gts: Dict, res: Dict) -> Tuple[bytes, bytes, List]:
    keys = list(gts.keys())
    gens = _RS.join(_as_text(res[k][0]) for k in keys)
    refs = _RS.join(_FS.join(_as_text(r) for r in gts[k]) for k in keys)
    return gens.encode(), refs.encode(), keys


def _read_scores(lib: ctypes.CDLL, ptr, n: int, what: str) -> Tuple[float, np.ndarray]:
    """(mean, per-record scores) out of the library's n + 1 doubles, which
    are freed here."""
    if not ptr:
        raise RuntimeError(f"native {what} failed")
    values = np.ctypeslib.as_array(ptr, shape=(n + 1,)).copy()
    lib.ov_free(ctypes.cast(ptr, ctypes.c_void_p))
    return float(values[0]), values[1:]


class NativeCider:
    """CIDEr; ``gts`` precomputes the document frequencies once (the SCST
    reward's train split), as ``evaluation.Cider(gts)`` does."""

    def __init__(self, gts: Optional[Dict] = None):
        lib = self._lib = _require()
        self._handle = None
        if gts is not None:
            refs = _RS.join(_FS.join(_as_text(r) for r in refs_i) for refs_i in gts.values())
            self._handle = lib.ov_cider_new(refs.encode())

    def compute_score(self, gts: Dict, res: Dict):
        lib = self._lib
        gens_b, refs_b, keys = _encode_pairs(gts, res)
        return _read_scores(lib, lib.ov_cider_score(self._handle, gens_b, refs_b), len(keys),
                            "cider")

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.ov_cider_delete(self._handle)

    def __str__(self) -> str:
        return "CIDEr"


class NativeMeteor:
    """Classic (2007-parameter) METEOR, as ``evaluation.MeteorClassic``."""

    def compute_score(self, gts: Dict, res: Dict):
        lib = _require()
        gens_b, refs_b, keys = _encode_pairs(gts, res)
        return _read_scores(lib, lib.ov_meteor_score(gens_b, refs_b), len(keys), "meteor")

    def __str__(self) -> str:
        return "METEOR"


def _too_long(text) -> bool:
    """The native aligner tracks spans in two 64-bit masks, so a segment is
    capped at 128 tokens; the Python scorer's masks are unbounded."""
    return len(str(text).split()) > 128


class NativeMeteor15:
    """METEOR 1.5 (en-norm parameters), as ``evaluation.Meteor``
    (``meteor15.py``), through all four stages (exact, stem, synonym,
    paraphrase), on the same function-word, synonym and paraphrase data
    the Python scorer resolves.  A batch holding a segment longer than the
    native aligner's 128 tokens goes to the Python scorer whole."""

    def compute_score(self, gts: Dict, res: Dict):
        lib = _require()
        from openviic_tpu_torch.evaluation.meteor15 import (
            Meteor15,
            _function_words,
            _paraphrase_lines,
            _synonym_lines,
        )

        if any(_too_long(res[k][0]) or any(_too_long(r) for r in gts[k]) for k in gts):
            return Meteor15().compute_score(gts, res)
        gens_b, refs_b, keys = _encode_pairs(gts, res)
        fwords = " ".join(sorted(_function_words())).encode()
        syn_lines = _synonym_lines()
        par_lines = _paraphrase_lines()
        if par_lines:
            if not hasattr(lib, "ov_meteor15_score_par"):
                raise RuntimeError("stale native library lacks the paraphrase stage")
            ptr = lib.ov_meteor15_score_par(gens_b, refs_b, fwords,
                                            "\n".join(syn_lines or ()).encode(),
                                            "\n".join(par_lines).encode())
        elif syn_lines:
            if not hasattr(lib, "ov_meteor15_score_syn"):
                raise RuntimeError("stale native library lacks the synonym stage")
            ptr = lib.ov_meteor15_score_syn(gens_b, refs_b, fwords,
                                            "\n".join(syn_lines).encode())
        elif hasattr(lib, "ov_meteor15_score"):
            ptr = lib.ov_meteor15_score(gens_b, refs_b, fwords)
        else:
            raise RuntimeError("stale native library lacks METEOR 1.5")
        return _read_scores(lib, ptr, len(keys), "meteor15")

    def __str__(self) -> str:
        return "METEOR"


def meteor15_entry_point() -> str:
    """The METEOR 1.5 entry point that the configured data needs: the
    paraphrase stage when a paraphrase table resolves, else the synonym
    stage when synonyms do, else the plain one."""
    from openviic_tpu_torch.evaluation.meteor15 import _paraphrase_table, _synonym_lines

    if _paraphrase_table() is not None:
        return "ov_meteor15_score_par"
    if _synonym_lines():
        return "ov_meteor15_score_syn"
    return "ov_meteor15_score"


def ptb_tokenize_batch(lines: Sequence[str]) -> List[str]:
    """PTB-tokenize each line (``evaluation.PTBTokenizer``'s output)."""
    lib = _require()
    raw = lib.ov_ptb_tokenize(_RS.join(lines).encode())
    if not raw:
        raise RuntimeError("native ptb tokenizer failed")
    try:
        text = ctypes.cast(raw, ctypes.c_char_p).value.decode()
    finally:
        lib.ov_free(raw)
    return text.split(_RS)
