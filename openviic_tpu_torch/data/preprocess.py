"""Host-side caption preprocessing: the port's copy of
``openviic_tpu/data/preprocess.py``'s punctuation rules and tokenizers.

The same punctuation-splitting regex rules in the same order, lowercasing
and whitespace normalisation, so tokens (and vocab ids) come out the same.
The tokenizers are ``None`` (identity), a callable and ``rdr``, the native
word segmenter (``data/rdr_segmenter.py``); ``pyvi``, ``spacy`` and
``vncorenlp`` are packages (the last also a Java server) and raise
``NotImplementedError``."""

from __future__ import annotations

import re
from typing import Callable, List, Union

# (pattern, replacement) pairs applied in order
_PUNCT_RULES = [
    (re.compile(r"[“”]"), '"'),
    (re.compile(r"!"), " ! "),
    (re.compile(r"\?"), " ? "),
    (re.compile(r":"), " : "),
    (re.compile(r";"), " ; "),
    (re.compile(r","), " , "),
    (re.compile(r"\""), ' " '),
    (re.compile(r"'"), " ' "),
    (re.compile(r"\("), " ( "),
    (re.compile(r"\["), " [ "),
    (re.compile(r"\)"), " ) "),
    (re.compile(r"\]"), " ] "),
    (re.compile(r"/"), " / "),
    (re.compile(r"\."), " . "),
    (re.compile(r"\$"), " $ "),
    (re.compile(r"\&"), " & "),
    (re.compile(r"\*"), " * "),
]


def get_tokenizer(tokenizer: Union[None, str, Callable]) -> Callable[[str], str]:
    """Resolve a tokenizer spec to a callable str -> str."""
    if tokenizer is None:
        return lambda s: s
    if callable(tokenizer):
        return tokenizer
    if tokenizer == "rdr":
        from openviic_tpu_torch.data.rdr_segmenter import RDRSegmenter

        return RDRSegmenter.default().tokenize
    if tokenizer in ("pyvi", "spacy", "vncorenlp"):
        raise NotImplementedError(f"tokenizer {tokenizer!r} needs a package the port does "
                                  "not use")
    raise ValueError(f"Unknown tokenizer {tokenizer!r}")


def preprocess_caption(caption: str, tokenizer: Union[None, str, Callable]) -> List[str]:
    """Split punctuation, lowercase, tokenize, and return a token list."""
    for pattern, repl in _PUNCT_RULES:
        caption = pattern.sub(repl, caption)
    caption = get_tokenizer(tokenizer)(caption.lower())
    caption = " ".join(caption.strip().split())
    return caption.strip().split()
