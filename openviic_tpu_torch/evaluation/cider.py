"""CIDEr (Vedantam et al., 2015) with n = 4, sigma = 6.

Numerically equivalent to the COCO-caption CIDEr used by the reference
(evaluation/cider/cider_scorer.py): tf-idf n-gram cosine with count
clipping and a Gaussian length penalty.  Supports precomputed document
frequencies + reference length so SCST can reuse the train-split statistics
every iteration (reference cider.py:24-28 / trainers/vi_trainer.py:35).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, Optional

import numpy as np

from openviic_tpu_torch.evaluation.ngram import ngram_counts


class Cider:
    def __init__(self, gts: Optional[Dict] = None, n: int = 4, sigma: float = 6.0):
        self._n = n
        self._sigma = sigma
        self.doc_frequency: Optional[Dict] = None
        self.ref_len: Optional[float] = None
        if gts is not None:
            self.doc_frequency, self.ref_len = self._compute_doc_freq(gts)

    def _compute_doc_freq(self, gts: Dict):
        doc_frequency: Dict = defaultdict(float)
        for refs in gts.values():
            seen = set()
            for ref in refs:
                seen.update(ngram_counts(_as_text(ref), self._n).keys())
            for ngram in seen:
                doc_frequency[ngram] += 1
        ref_len = np.log(float(len(gts)))
        return doc_frequency, ref_len

    def _counts2vec(self, cnts: Counter, doc_frequency, ref_len):
        vec = [defaultdict(float) for _ in range(self._n)]
        length = 0
        norm = [0.0] * self._n
        for ngram, term_freq in cnts.items():
            df = np.log(max(1.0, doc_frequency[ngram]))
            k = len(ngram) - 1
            vec[k][ngram] = float(term_freq) * (ref_len - df)
            norm[k] += vec[k][ngram] ** 2
            if k == 1:
                length += term_freq
        norm = [np.sqrt(v) for v in norm]
        return vec, norm, length

    def _sim(self, vec_hyp, vec_ref, norm_hyp, norm_ref, length_hyp, length_ref):
        delta = float(length_hyp - length_ref)
        val = np.zeros(self._n)
        for k in range(self._n):
            for ngram, count in vec_hyp[k].items():
                val[k] += min(vec_hyp[k][ngram], vec_ref[k][ngram]) * vec_ref[k][ngram]
            if norm_hyp[k] != 0 and norm_ref[k] != 0:
                val[k] /= norm_hyp[k] * norm_ref[k]
            assert not math.isnan(val[k])
            val[k] *= np.e ** (-(delta**2) / (2 * self._sigma**2))
        return val

    def compute_score(self, gts: Dict, res: Dict):
        assert gts.keys() == res.keys()
        if self.doc_frequency is not None:
            doc_frequency, ref_len = self.doc_frequency, self.ref_len
        else:
            doc_frequency, ref_len = self._compute_doc_freq(gts)

        scores = []
        for image_id in gts:
            test = ngram_counts(_as_text(res[image_id][0]), self._n)
            vec, norm, length = self._counts2vec(test, doc_frequency, ref_len)
            score = np.zeros(self._n)
            refs = gts[image_id]
            for ref in refs:
                rc = ngram_counts(_as_text(ref), self._n)
                vec_ref, norm_ref, length_ref = self._counts2vec(
                    rc, doc_frequency, ref_len
                )
                score += self._sim(vec, vec_ref, norm, norm_ref, length, length_ref)
            score_avg = np.mean(score) / len(refs) * 10.0
            scores.append(score_avg)

        return float(np.mean(scores)), np.array(scores)

    def __str__(self) -> str:
        return "CIDEr"


def _as_text(x) -> str:
    """Accept either a caption string or a token list."""
    if isinstance(x, (list, tuple)):
        return " ".join(x)
    return x
