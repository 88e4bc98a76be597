"""PTB tokenizer for caption evaluation, native (no JVM).

The reference shells out to Stanford CoreNLP's PTBTokenizer over a temp
file (evaluation/tokenizer.py:23-62) with options
``americanize=false, normalizeCurrency=false, normalizeParentheses=false,
normalizeOtherBrackets=false`` and then removes a fixed punctuation list
and lowercases.  This module implements the same pipeline as deterministic
regex string processing on the host CPU:

 1. PTB-style tokenization (split punctuation, contractions n't/'s/'re/...,
    ellipses, separate symbols);
 2. drop tokens in the reference's PUNCTUATIONS list (tokenizer.py:12-14);
 3. lowercase and re-join with single spaces.

Interface parity: ``PTBTokenizer.tokenize({key: [caption, ...]}) ->
{key: [tokenized_caption, ...]}``.
"""

from __future__ import annotations

import re
from typing import Dict, List

# the reference's removed-punctuation list (evaluation/tokenizer.py:12-14)
PUNCTUATIONS = [
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
]

_CONTRACTIONS = re.compile(
    r"(?i)(\w+)(n't|'s|'re|'ve|'ll|'d|'m)\b"
)

_RULES = [
    # ellipses first (placeholder keeps the period rule from re-splitting)
    (re.compile(r"\.\.\."), " \x00ellipsis\x00 "),
    # separate most punctuation
    (re.compile(r"([;@#$%&!?,:])"), r" \1 "),
    # periods at end of token sequences (simple sentence-final split)
    (re.compile(r"\.(\s|$)"), r" . \1"),
    # brackets -> PTB tags
    (re.compile(r"\("), " -LRB- "),
    (re.compile(r"\)"), " -RRB- "),
    (re.compile(r"\{"), " -LCB- "),
    (re.compile(r"\}"), " -RCB- "),
    (re.compile(r"\["), " -LSB- "),
    (re.compile(r"\]"), " -RSB- "),
    # quotes
    (re.compile(r'"'), " '' "),
    (re.compile(r"([^'])' "), r"\1 ' "),
    # dashes
    (re.compile(r"--"), " -- "),
]


def ptb_tokenize_line(line: str) -> List[str]:
    s = " " + line + " "
    s = _CONTRACTIONS.sub(r"\1 \2", s)
    for pattern, repl in _RULES:
        s = pattern.sub(repl, s)
    s = s.replace("\x00ellipsis\x00", "...")
    return s.split()


class PTBTokenizer:
    def tokenize(self, captions_for_image: Dict) -> Dict:
        out: Dict = {}
        for key, caps in captions_for_image.items():
            out[key] = []
            for cap in caps:
                if isinstance(cap, dict):  # COCO-style {"caption": ...}
                    cap = cap["caption"]
                tokens = ptb_tokenize_line(cap.replace("\n", " "))
                kept = [t.lower() for t in tokens if t not in PUNCTUATIONS]
                out[key].append(" ".join(kept))
        return out
