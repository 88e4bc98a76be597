"""Shared n-gram counting utilities for the caption metrics."""

from __future__ import annotations

from collections import Counter
from typing import Tuple

NGram = Tuple[str, ...]


def ngram_counts(sentence: str, max_n: int = 4) -> Counter:
    """Counts of all 1..max_n-grams of a whitespace-tokenized sentence."""
    words = sentence.split()
    counts: Counter = Counter()
    for n in range(1, max_n + 1):
        for i in range(len(words) - n + 1):
            counts[tuple(words[i : i + n])] += 1
    return counts
