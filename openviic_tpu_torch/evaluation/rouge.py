"""ROUGE-L (Lin & Hovy 2004) with beta = 1.2.

Numerically equivalent to the COCO-caption ROUGE used by the reference
(evaluation/rouge/rouge.py): per-image score is the F-measure of the *max*
LCS precision and *max* LCS recall over the references (maxima taken
independently).  The O(n*m) LCS runs on numpy int arrays instead of the
reference's pure-Python list-of-lists.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _lcs_length(a: List[str], b: List[str]) -> int:
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return 0
    prev = np.zeros(len(b) + 1, dtype=np.int32)
    for x in a:
        cur = prev.copy()
        for j, y in enumerate(b, start=1):
            if x == y:
                cur[j] = prev[j - 1] + 1
            elif cur[j - 1] > prev[j]:
                cur[j] = cur[j - 1]
            else:
                cur[j] = prev[j]
        prev = cur
    return int(prev[-1])


class Rouge:
    def __init__(self):
        self.beta = 1.2

    def calc_score(self, candidate: List[str], refs: List[str]) -> float:
        assert len(candidate) == 1
        assert len(refs) > 0
        token_c = candidate[0].split(" ")

        prec, rec = [], []
        for reference in refs:
            token_r = reference.split(" ")
            lcs = _lcs_length(token_r, token_c)
            prec.append(lcs / float(len(token_c)))
            rec.append(lcs / float(len(token_r)))

        prec_max, rec_max = max(prec), max(rec)
        if prec_max != 0 and rec_max != 0:
            return ((1 + self.beta**2) * prec_max * rec_max) / float(
                rec_max + self.beta**2 * prec_max
            )
        return 0.0

    def compute_score(self, gts: Dict, res: Dict):
        assert gts.keys() == res.keys()
        scores = [self.calc_score(res[i], gts[i]) for i in gts]
        return float(np.mean(scores)), np.array(scores)

    def __str__(self) -> str:
        return "ROUGE"
