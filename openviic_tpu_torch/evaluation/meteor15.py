"""METEOR 1.5 scorer (Denkowski & Lavie 2014), native — no JVM.

Replicates the parameterisation the reference uses through the METEOR 1.5
jar with ``-l en -norm`` (reference evaluation/meteor/meteor.py:26-65):

 - English ranking-task parameters: alpha=0.85, beta=0.2, gamma=0.6,
   delta=0.75; module weights exact=1.0, stem=0.6, synonym=0.8,
   paraphrase=0.6;
 - content/function-word weighting (delta for content words);
 - weighted precision/recall over stage matches:
     P = sum_i w_i (d*m_i(h_c) + (1-d)*m_i(h_f)) / (d*|h_c| + (1-d)*|h_f|)
   (R analogous on the reference side), Fmean = P*R/(a*P + (1-a)*R),
   Pen = g*(ch/m)^b with m the matched-word count averaged over sides,
   score = (1 - Pen) * Fmean;
 - per-segment best reference; corpus score from aggregated statistics
   (the jar's aggregation), not the mean of segment scores.

Stages: exact and Porter-stem always run.  The synonym stage and the
content/function weighting run out of the box from BUNDLED data
(``evaluation/data/``): a curated WordNet-core-style synset table
(``meteor_synonyms_en.txt``, caption-domain weighted) and a function-word
list (built-in frequency list ∪ the public Glasgow IR stop list).  The
bundled tables are approximations — the jar's exact WordNet 3.0 /
``paraphrase-en.gz`` data is not redistributable here (zero-egress
build environment; the reference repo ships neither the jar nor its
data, evaluation/meteor/meteor.py:26-65 expects them installed).  For
exact jar parity, override with:

 - ``OPENVIIC_METEOR_SYNONYMS``: text file, one synset per line,
   space-separated member words (export from the jar's WordNet data);
 - ``OPENVIIC_METEOR_PARAPHRASE``: (optionally gzipped) table with lines
   ``phrase ||| paraphrase`` (the meteor paraphrase-en.gz format;
   provenance: http://www.cs.cmu.edu/~alavie/METEOR/ distribution — the
   paraphrase stage stays off until this file is supplied);
 - ``OPENVIIC_METEOR_FUNCTION_WORDS``: one function word per line
   (the jar's function/en.words file).

Alignment follows the jar's one-best beam search over hypothesis
positions: candidate matches from every stage, partial alignments ranked
by (most matched words, fewest chunks, smallest total start distance),
beam width 40.  Without the synonym/paraphrase data the scores are exact
+ stem only — slightly below jar-scored values on English; with the data
files supplied the remaining differences are beam-search tie-breaks.
"""

from __future__ import annotations

import gzip
import os
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from openviic_tpu_torch.evaluation.porter import porter_stem

ALPHA = 0.85
BETA = 0.2
GAMMA = 0.6
DELTA = 0.75
MODULE_WEIGHTS = (1.0, 0.6, 0.8, 0.6)  # exact, stem, synonym, paraphrase
BEAM = 40

# Approximation of meteor-1.5's English function-word list (words with
# corpus relative frequency >= 1e-3); override with
# OPENVIIC_METEOR_FUNCTION_WORDS for jar parity.
_DEFAULT_FUNCTION_WORDS = frozenset(
    """a an the this that these those some any each every no all both few
    i you he she it we they me him her us them my your his its our their
    mine yours hers ours theirs myself yourself himself herself itself
    ourselves themselves who whom whose which what
    is am are was were be been being do does did done doing have has had
    having will would shall should can could may might must
    and or but nor so yet if then else when while because although though
    since unless until whether as than
    in on at by for with about against between into through during before
    after above below to from up down out off over under again further
    of not only own same too very just also there here where why how
    's 't n't 'll 're 've 'd 'm""".split()
)


_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _load_lines(path: Optional[str]) -> Optional[List[str]]:
    if not path or not os.path.exists(path):
        return None
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8", errors="replace") as f:
        return [
            line.rstrip("\n")
            for line in f
            if line.strip() and not line.startswith("#")
        ]


def _data_file(env_var: str, bundled: str) -> Optional[str]:
    """Env override first, bundled package data second."""
    path = os.environ.get(env_var)
    if path:
        return path
    bundled_path = os.path.join(_DATA_DIR, bundled)
    return bundled_path if os.path.exists(bundled_path) else None


@lru_cache(maxsize=1)
def _function_words() -> frozenset:
    lines = _load_lines(
        _data_file(
            "OPENVIIC_METEOR_FUNCTION_WORDS", "meteor_function_words_en.txt"
        )
    )
    if lines:
        return frozenset(w.strip() for w in lines if w.strip())
    return _DEFAULT_FUNCTION_WORDS


@lru_cache(maxsize=1)
def _synonym_lines() -> Optional[Tuple[str, ...]]:
    """Raw synset lines (one synset per line) — shared with the native
    C++ scorer so both implementations read one data source."""
    lines = _load_lines(
        _data_file("OPENVIIC_METEOR_SYNONYMS", "meteor_synonyms_en.txt")
    )
    return tuple(lines) if lines else None


@lru_cache(maxsize=1)
def _synonym_sets() -> Optional[Dict[str, set]]:
    """word -> set of synset ids it belongs to."""
    lines = _synonym_lines()
    if not lines:
        return None
    table: Dict[str, set] = {}
    for idx, line in enumerate(lines):
        for word in line.split():
            table.setdefault(word, set()).add(idx)
    return table


@lru_cache(maxsize=1)
def _paraphrase_lines() -> Optional[Tuple[str, ...]]:
    """Raw ``phrase ||| paraphrase`` lines — shared with the native C++
    scorer so both implementations read one data source."""
    lines = _load_lines(os.environ.get("OPENVIIC_METEOR_PARAPHRASE"))
    return tuple(lines) if lines else None


@lru_cache(maxsize=1)
def _paraphrase_table() -> Optional[Dict[str, set]]:
    """phrase -> set of paraphrase phrases (both directions)."""
    lines = _paraphrase_lines()
    if not lines:
        return None
    table: Dict[str, set] = {}
    for line in lines:
        parts = line.split("|||")
        if len(parts) < 2:
            continue
        a, b = parts[0].strip(), parts[1].strip()
        if a and b and a != b:
            table.setdefault(a, set()).add(b)
            table.setdefault(b, set()).add(a)
    return table


# A match: (hyp_start, hyp_len, ref_start, ref_len, module)
Match = Tuple[int, int, int, int, int]


def _collect_matches(hyp: Sequence[str], ref: Sequence[str]) -> List[Match]:
    matches: List[Match] = []
    hyp_stems = [porter_stem(w) for w in hyp]
    ref_stems = [porter_stem(w) for w in ref]
    syn = _synonym_sets()
    for i, hw in enumerate(hyp):
        for j, rw in enumerate(ref):
            if hw == rw:
                matches.append((i, 1, j, 1, 0))
            elif hyp_stems[i] == ref_stems[j]:
                matches.append((i, 1, j, 1, 1))
            elif syn is not None and syn.get(hw) and syn.get(rw) and (
                syn[hw] & syn[rw]
            ):
                matches.append((i, 1, j, 1, 2))
    par = _paraphrase_table()
    if par is not None:
        max_len = 4  # meteor limits paraphrase phrases to short spans
        hyp_spans = {}
        for i in range(len(hyp)):
            for n in range(1, min(max_len, len(hyp) - i) + 1):
                hyp_spans.setdefault(" ".join(hyp[i : i + n]), []).append((i, n))
        for j in range(len(ref)):
            for n in range(1, min(max_len, len(ref) - j) + 1):
                rp = " ".join(ref[j : j + n])
                for alt in par.get(rp, ()):
                    for (i, hn) in hyp_spans.get(alt, ()):
                        matches.append((i, hn, j, n, 3))
    return matches


def _chunks(pairs: List[Match]) -> int:
    """Maximal runs contiguous in both orders (phrase spans count once)."""
    if not pairs:
        return 0
    pairs = sorted(pairs)
    ch = 1
    for (h0, hl0, r0, rl0, _), (h1, _, r1, _, _) in zip(pairs, pairs[1:]):
        if h1 != h0 + hl0 or r1 != r0 + rl0:
            ch += 1
    return ch


def _align(hyp: Sequence[str], ref: Sequence[str]) -> List[Match]:
    """One-best beam search: most matched words, fewest chunks, smallest
    total distance (the jar's Aligner ordering)."""
    cands = _collect_matches(hyp, ref)
    if not cands:
        return []
    by_start: Dict[int, List[Match]] = {}
    for m in cands:
        by_start.setdefault(m[0], []).append(m)

    # state: (hyp_covered_mask, ref_covered_mask, matches_tuple)
    states = [(0, 0, ())]
    for i in range(len(hyp)):
        new_states = []
        for hm, rm, ms in states:
            new_states.append((hm, rm, ms))  # skip position i
            if (hm >> i) & 1:
                continue
            for cand in by_start.get(i, ()):
                h0, hl, r0, rl, _ = cand
                hmask = ((1 << hl) - 1) << h0
                rmask = ((1 << rl) - 1) << r0
                if (hm & hmask) or (rm & rmask):
                    continue
                new_states.append((hm | hmask, rm | rmask, ms + (cand,)))

        def rank(state):
            hm, rm, ms = state
            covered = bin(hm).count("1") + bin(rm).count("1")
            dist = sum(abs(m[0] - m[2]) for m in ms)
            return (-covered, _chunks(list(ms)), dist)

        new_states.sort(key=rank)
        states = new_states[:BEAM]
    return list(states[0][2])


def _segment_stats(hyp_words: List[str], ref_words: List[str]):
    """(p_num, p_den, r_num, r_den, matches_avg, chunks) for one pair."""
    func = _function_words()
    matches = _align(hyp_words, ref_words)

    def side_weight(words, start, length, weighted=True):
        total = 0.0
        for idx in range(start, start + length):
            is_func = words[idx] in func
            total += (1 - DELTA) if is_func else DELTA
        return total

    p_num = r_num = 0.0
    m_h = m_r = 0
    for (h0, hl, r0, rl, module) in matches:
        w = MODULE_WEIGHTS[module]
        p_num += w * side_weight(hyp_words, h0, hl)
        r_num += w * side_weight(ref_words, r0, rl)
        m_h += hl
        m_r += rl
    p_den = side_weight(hyp_words, 0, len(hyp_words))
    r_den = side_weight(ref_words, 0, len(ref_words))
    ch = _chunks(matches)
    m_avg = 0.5 * (m_h + m_r)
    return (p_num, p_den, r_num, r_den, m_avg, ch)


def _score_from_stats(stats) -> float:
    p_num, p_den, r_num, r_den, m_avg, ch = stats
    if p_den <= 0 or r_den <= 0 or m_avg <= 0:
        return 0.0
    precision = p_num / p_den
    recall = r_num / r_den
    if precision <= 0 or recall <= 0:
        return 0.0
    fmean = precision * recall / (ALPHA * precision + (1 - ALPHA) * recall)
    pen = GAMMA * (ch / m_avg) ** BETA
    return fmean * (1.0 - pen)


class Meteor15:
    """METEOR 1.5 with the reference jar's en-norm parameterisation."""

    def compute_score(self, gts: Dict, res: Dict):
        assert gts.keys() == res.keys()
        scores = []
        agg = np.zeros(6)
        for image_id in gts:
            hypo = res[image_id]
            assert isinstance(hypo, list) and len(hypo) == 1
            hyp_words = hypo[0].split()
            best_stats, best = None, -1.0
            for ref in gts[image_id]:
                stats = _segment_stats(hyp_words, ref.split())
                score = _score_from_stats(stats)
                if score > best:
                    best, best_stats = score, stats
            scores.append(max(best, 0.0))
            if best_stats is not None:
                agg += np.asarray(best_stats)
        return float(_score_from_stats(tuple(agg))), np.array(scores)

    def __str__(self) -> str:
        return "METEOR"
