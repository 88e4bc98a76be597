"""Native METEOR scorer (no JVM).

The reference shells out to the METEOR 1.5 jar over a stdio line protocol
(evaluation/meteor/meteor.py:26-65), hard-coding English even for
Vietnamese (meteor.py:27 — SURVEY.md §2.5#10).  This module scores
natively with the METEOR algorithm:

 - stage-wise word alignment (exact match, then Porter-stemmed match),
   greedy leftmost matching per stage, chunk count from the final mapping;
 - classic METEOR parameters (Lavie & Agarwal 2007, also NLTK's):
   alpha=0.9, beta=3, gamma=0.5; Fmean = P*R/(alpha*P + (1-alpha)*R),
   penalty = gamma*(chunks/matches)**beta;
 - per-segment score = Fmean * (1 - penalty), best reference taken;
 - corpus score from aggregated statistics of each segment's best
   reference (as the jar aggregates), not the mean of segment scores.

This is the *classic* (2007) parameterisation, kept for comparison and
for the native C++ scorer parity tests.  The default METEOR used by
``compute_scores`` is the 1.5 en-norm parameterisation matching the
reference's jar invocation — see meteor15.py.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from openviic_tpu_torch.evaluation.porter import porter_stem

ALPHA = 0.9
BETA = 3.0
GAMMA = 0.5


def _align(hyp: List[str], ref: List[str]) -> List[Tuple[int, int]]:
    """Stage-wise greedy alignment; returns (hyp_idx, ref_idx) pairs."""
    pairs: List[Tuple[int, int]] = []
    hyp_free = set(range(len(hyp)))
    ref_free = set(range(len(ref)))

    # stage 1: exact
    for i in sorted(hyp_free):
        for j in sorted(ref_free):
            if hyp[i] == ref[j]:
                pairs.append((i, j))
                hyp_free.discard(i)
                ref_free.discard(j)
                break

    # stage 2: stem
    hyp_stem = {i: porter_stem(hyp[i]) for i in hyp_free}
    ref_stem = {j: porter_stem(ref[j]) for j in ref_free}
    for i in sorted(hyp_free):
        for j in sorted(ref_free):
            if hyp_stem[i] == ref_stem[j]:
                pairs.append((i, j))
                hyp_free.discard(i)
                ref_free.discard(j)
                break

    return sorted(pairs)


def _chunks(pairs: List[Tuple[int, int]]) -> int:
    """Number of maximal runs contiguous in both hyp and ref order."""
    if not pairs:
        return 0
    chunks = 1
    for (h0, r0), (h1, r1) in zip(pairs, pairs[1:]):
        if h1 != h0 + 1 or r1 != r0 + 1:
            chunks += 1
    return chunks


def _segment_stats(hyp: str, refs: List[str]):
    """Best-reference (matches, hyp_len, ref_len, chunks) for one segment."""
    hyp_words = hyp.split()
    best = None
    best_score = -1.0
    for ref in refs:
        ref_words = ref.split()
        pairs = _align(hyp_words, ref_words)
        m = len(pairs)
        stats = (m, len(hyp_words), len(ref_words), _chunks(pairs))
        score = _score_from_stats(*stats)
        if score > best_score:
            best_score = score
            best = stats
    return best, best_score


def _score_from_stats(m: int, hyp_len: int, ref_len: int, ch: int) -> float:
    if m == 0 or hyp_len == 0 or ref_len == 0:
        return 0.0
    precision = m / hyp_len
    recall = m / ref_len
    fmean = precision * recall / (ALPHA * precision + (1 - ALPHA) * recall)
    frag = ch / m
    penalty = GAMMA * (frag**BETA)
    return fmean * (1 - penalty)


class MeteorClassic:
    def compute_score(self, gts: Dict, res: Dict):
        assert gts.keys() == res.keys()
        scores = []
        agg_m = agg_h = agg_r = agg_c = 0
        for image_id in gts:
            hypo = res[image_id]
            assert isinstance(hypo, list) and len(hypo) == 1
            stats, score = _segment_stats(hypo[0], gts[image_id])
            scores.append(score)
            if stats is not None:
                m, h, r, c = stats
                agg_m += m
                agg_h += h
                agg_r += r
                agg_c += c
        corpus = _score_from_stats(agg_m, agg_h, agg_r, agg_c)
        return float(corpus), np.array(scores)

    def __str__(self) -> str:
        return "METEOR"


# backwards-compatible alias (the 2007-parameter scorer)
Meteor2007 = MeteorClassic
