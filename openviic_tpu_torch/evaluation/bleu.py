"""Corpus BLEU-1..4 for image captioning.

Numerically equivalent to the COCO-caption BLEU used by the reference
(evaluation/bleu/bleu_scorer.py): per-n-gram clipped counts against the
max reference counts, 'closest' effective reference length, the
``tiny``/``small`` smoothing constants, and the e^(1-1/ratio) brevity
penalty applied when ratio < 1.  Returns both the corpus-level scores and
per-image running scores (the per-image entries are the cumulative-product
per-sentence values, exactly as the reference's ``bleu_list``).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List

from openviic_tpu_torch.evaluation.ngram import ngram_counts

_TINY = 1e-15
_SMALL = 1e-9


def _cook_refs(refs: List[str], n: int):
    reflens = []
    maxcounts: Counter = Counter()
    for ref in refs:
        counts = ngram_counts(ref, n)
        reflens.append(len(ref.split()))
        for ngram, count in counts.items():
            if count > maxcounts[ngram]:
                maxcounts[ngram] = count
    return reflens, maxcounts


def _closest_reflen(reflens: List[int], testlen: int) -> int:
    return min((abs(l - testlen), l) for l in reflens)[1]


class Bleu:
    def __init__(self, n: int = 4):
        self._n = n

    def compute_score(self, gts: Dict, res: Dict):
        assert gts.keys() == res.keys()
        n = self._n

        totals = {"testlen": 0, "reflen": 0, "guess": [0] * n, "correct": [0] * n}
        bleu_list: List[List[float]] = [[] for _ in range(n)]

        for image_id in gts:
            hypo = res[image_id]
            refs = gts[image_id]
            assert isinstance(hypo, list) and len(hypo) == 1
            assert isinstance(refs, list) and len(refs) >= 1

            test_counts = ngram_counts(hypo[0], n)
            testlen = len(hypo[0].split())
            reflens, refmax = _cook_refs(refs, n)
            reflen = _closest_reflen(reflens, testlen)

            guess = [max(0, testlen - k + 1) for k in range(1, n + 1)]
            correct = [0] * n
            for ngram, count in test_counts.items():
                correct[len(ngram) - 1] += min(refmax.get(ngram, 0), count)

            totals["testlen"] += testlen
            totals["reflen"] += reflen
            for k in range(n):
                totals["guess"][k] += guess[k]
                totals["correct"][k] += correct[k]

            # per-sentence score
            bleu = 1.0
            for k in range(n):
                bleu *= (correct[k] + _TINY) / (guess[k] + _SMALL)
                bleu_list[k].append(bleu ** (1.0 / (k + 1)))
            ratio = (testlen + _TINY) / (reflen + _SMALL)
            if ratio < 1:
                for k in range(n):
                    bleu_list[k][-1] *= math.exp(1 - 1 / ratio)

        # corpus score
        bleus = []
        bleu = 1.0
        for k in range(n):
            bleu *= (totals["correct"][k] + _TINY) / (totals["guess"][k] + _SMALL)
            bleus.append(bleu ** (1.0 / (k + 1)))
        ratio = (totals["testlen"] + _TINY) / (totals["reflen"] + _SMALL)
        if ratio < 1:
            for k in range(n):
                bleus[k] *= math.exp(1 - 1 / ratio)

        return bleus, bleu_list

    def __str__(self) -> str:
        return "BLEU"
