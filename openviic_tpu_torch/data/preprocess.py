"""Host-side caption preprocessing: the port's copy of
``openviic_tpu/data/preprocess.py``'s punctuation rules and its identity
tokenizer.

The same punctuation-splitting regex rules in the same order, lowercasing
and whitespace normalisation, so tokens (and vocab ids) come out the same.
Only the ``None`` tokenizer is ported; the word segmenters (``pyvi``,
``spacy``, ``vncorenlp``, ``rdr``) raise ``NotImplementedError``."""

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
    raise NotImplementedError(f"tokenizer {tokenizer!r} is not ported yet")


def preprocess_caption(caption: str, tokenizer: Union[None, str, Callable]) -> List[str]:
    """Split punctuation, lowercase, tokenize, and return a token list."""
    for pattern, repl in _PUNCT_RULES:
        caption = pattern.sub(repl, caption)
    caption = get_tokenizer(tokenizer)(caption.lower())
    caption = " ".join(caption.strip().split())
    return caption.strip().split()
