"""The port's caption scorers (``openviic_tpu_torch.evaluation``) against the
JAX package's: every scorer and ``compute_scores`` on the JAX f32 beam-5
decode of the trained artifact's 150 test images against their references
(within 1e-12), then the hand-computed cases of tests/test_evaluation.py
run against the port."""

import itertools
import math
import sys
from pathlib import Path

import numpy as np
import pytest

import openviic_tpu.evaluation as jax_eval
import openviic_tpu_torch.evaluation as port_eval
from openviic_tpu_torch.evaluation import Bleu, Cider, Meteor, MeteorClassic, Rouge, compute_scores
from openviic_tpu_torch.evaluation.ptb_tokenizer import PTBTokenizer

SCRIPTS = str(Path(__file__).resolve().parent.parent / "scripts")
TOL = 1e-12


@pytest.fixture(scope="module")
def decoded(tmp_path_factory):
    """(gts, gens): the JAX package's f32 beam-5 captions of the artifact's
    test images, repeats collapsed as its bench scores them, and the
    references."""
    import jax.numpy as jnp

    from openviic_tpu.decoding import beam_search

    sys.path.insert(0, SCRIPTS)  # the JAX loader imports its config from there
    try:
        from trained_artifact import load_trained_artifact

        a = load_trained_artifact(str(tmp_path_factory.mktemp("bench_trained")))
    finally:
        sys.path.remove(SCRIPTS)
    outs, _ = beam_search(a["model"], a["params"], {"region_features": jnp.asarray(a["feats"])},
                          beam_size=5, out_size=1, beam_resident=True)
    caps = a["vocab"].decode_caption(np.asarray(outs).reshape(len(a["ids"]), -1),
                                     join_words=False)
    gens = {i: [" ".join(k for k, _ in itertools.groupby(c))] for i, c in zip(a["ids"], caps)}
    return {i: a["refs"][i] for i in a["ids"]}, gens


def _close(got, want):
    if isinstance(want, (list, tuple, np.ndarray)):
        got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    else:
        assert abs(float(got) - float(want)) <= TOL


@pytest.mark.parametrize("name", ["Bleu", "Meteor", "MeteorClassic", "Rouge", "Cider"])
def test_scorer_equals_jax_on_the_artifact_decode(decoded, name):
    gts, gens = decoded
    want_score, want_scores = getattr(jax_eval, name)().compute_score(gts, gens)
    got_score, got_scores = getattr(port_eval, name)().compute_score(gts, gens)
    _close(got_score, want_score)
    _close(got_scores, want_scores)
    assert str(getattr(port_eval, name)()) == str(getattr(jax_eval, name)())


def test_compute_scores_equals_jax_on_the_artifact_decode(decoded):
    """The JAX package's compute_scores (its native METEOR and CIDEr where
    built, bit-identical to its Python ones) against the port's."""
    gts, gens = decoded
    want, want_per = jax_eval.compute_scores(gts, gens)
    got, got_per = compute_scores(gts, gens)
    assert set(got) == set(want) == {"BLEU", "METEOR", "ROUGE", "CIDEr"}
    for key in want:
        _close(got[key], want[key])
        _close(got_per[key], want_per[key])
    assert 0.05 < got["CIDEr"] < 0.5


def test_ptb_tokenizer_equals_jax_on_the_references(decoded):
    gts, _ = decoded
    assert PTBTokenizer().tokenize(gts) == jax_eval.PTBTokenizer().tokenize(gts)


# -- the hand-computed cases of tests/test_evaluation.py, on the port -------
def test_bleu_perfect_match():
    score, _ = Bleu().compute_score({"0": ["a b c d"]}, {"0": ["a b c d"]})
    assert len(score) == 4
    for s in score:
        assert s == pytest.approx(1.0, abs=1e-5)


def test_bleu_partial_match_hand_computed():
    score, _ = Bleu().compute_score({"0": ["a b c d"]}, {"0": ["a b c"]})
    bp = math.exp(1 - 1 / ((3 + 1e-15) / (4 + 1e-9)))
    tiny, small = 1e-15, 1e-9
    p = [(3 + tiny) / (3 + small), (2 + tiny) / (2 + small), (1 + tiny) / (1 + small),
         (0 + tiny) / (0 + small)]
    cum, expected = 1.0, []
    for k in range(4):
        cum *= p[k]
        expected.append(cum ** (1 / (k + 1)) * bp)
    np.testing.assert_allclose(score, expected, rtol=1e-9)


def test_bleu_closest_reflen():
    score, _ = Bleu().compute_score({"0": ["a b", "a b c d e f"]}, {"0": ["a b x"]})
    assert score[0] == pytest.approx(2.0 / 3.0, abs=1e-6)


def test_rouge_hand_computed():
    score, _ = Rouge().compute_score({"0": ["a c b d"]}, {"0": ["a b c d"]})
    p = r = 3 / 4
    beta = 1.2
    assert score == pytest.approx((1 + beta**2) * p * r / (r + beta**2 * p), abs=1e-9)
    score, _ = Rouge().compute_score({"0": ["a b c d", "x y"]}, {"0": ["a b c d"]})
    assert score == pytest.approx(1.0)


def test_cider_hand_computed():
    gts = {"0": ["a b c d e"], "1": ["v w x y z"]}
    score, scores = Cider().compute_score(gts, gts)
    assert score == pytest.approx(10.0, abs=1e-6)
    np.testing.assert_allclose(scores, [10.0, 10.0], atol=1e-6)
    cider = Cider(gts=gts)
    assert cider.doc_frequency is not None
    assert cider.compute_score(gts, gts)[0] == pytest.approx(10.0, abs=1e-6)
    score, _ = Cider().compute_score({"0": ["a b c d e f g h"], "1": ["p q r s t u v w"]},
                                     {"0": ["a b c"], "1": ["p q r"]})
    assert 0 < score < 10.0


def test_meteor_hand_computed():
    gts = {"0": ["the cat sat on the mat"]}
    _, scores = Meteor().compute_score(gts, gts)
    assert scores[0] == pytest.approx(1.0 - 0.6 * (1 / 6) ** 0.2, abs=1e-9)
    _, scores = MeteorClassic().compute_score(gts, gts)
    assert scores[0] == pytest.approx(1.0 * (1 - 0.5 * (1 / 6) ** 3), abs=1e-9)
    score, scores = Meteor().compute_score({"0": ["x y z"]}, {"0": ["a b c"]})
    assert score == 0.0 and scores[0] == 0.0
    _, scores = Meteor().compute_score({"0": ["the cats are running"]},
                                       {"0": ["the cat is run"]})
    assert scores[0] > 0.2


def test_meteor15_weights_and_fragmentation():
    gts = {"0": ["the dog runs"]}
    _, s_content = Meteor().compute_score(gts, {"0": ["a dog walks"]})
    _, s_function = Meteor().compute_score(gts, {"0": ["the cat walks"]})
    assert s_content[0] > s_function[0]
    _, scores = Meteor().compute_score({"0": ["a b c d e f"], "1": ["a b c d e f"]},
                                       {"0": ["a b c x y z"], "1": ["a x b y c z"]})
    assert scores[0] > scores[1]


def test_meteor15_paraphrase_and_synonym_files(tmp_path, monkeypatch):
    import openviic_tpu_torch.evaluation.meteor15 as m15

    gts, res = {"0": ["the man rides a xebike"]}, {"0": ["the man rides a xebicycle"]}
    _, before = Meteor().compute_score(gts, res)
    table = tmp_path / "paraphrase.txt"
    table.write_text("xebicycle ||| xebike\n")
    monkeypatch.setenv("OPENVIIC_METEOR_PARAPHRASE", str(table))
    m15._paraphrase_lines.cache_clear()
    m15._paraphrase_table.cache_clear()
    try:
        _, after = Meteor().compute_score(gts, res)
    finally:
        m15._paraphrase_lines.cache_clear()
        m15._paraphrase_table.cache_clear()
    assert after[0] > before[0]

    gts, res = {"0": ["a xelarge dog"]}, {"0": ["a xebig dog"]}
    _, before = Meteor().compute_score(gts, res)
    syn = tmp_path / "synsets.txt"
    syn.write_text("xebig xelarge xehuge\n")
    monkeypatch.setenv("OPENVIIC_METEOR_SYNONYMS", str(syn))
    m15._synonym_lines.cache_clear()
    m15._synonym_sets.cache_clear()
    try:
        _, after = Meteor().compute_score(gts, res)
    finally:
        m15._synonym_lines.cache_clear()
        m15._synonym_sets.cache_clear()
    assert after[0] > before[0]


def test_ptb_tokenizer():
    tok = PTBTokenizer()
    assert tok.tokenize({"0": ["A man, with a dog (brown), walks."]})["0"] == [
        "a man with a dog brown walks"]
    assert tok.tokenize({"0": ["He isn't here; she's gone..."]})["0"] == [
        "he is n't here she 's gone"]


def test_compute_scores_interface():
    gts = {"0": ["a b c d"], "1": ["x y z w"]}
    all_score, _ = compute_scores(gts, gts)
    assert set(all_score.keys()) == {"BLEU", "METEOR", "ROUGE", "CIDEr"}
    assert all_score["ROUGE"] == pytest.approx(1.0)
    assert all_score["CIDEr"] == pytest.approx(10.0, abs=1e-6)


def test_meteor15_analytic_goldens_and_bundled_synonyms():
    from openviic_tpu_torch.evaluation.meteor15 import (
        _DATA_DIR, BETA, GAMMA, Meteor15, _function_words)

    fw = _function_words()
    words = [w for w in ("dog", "runs", "street", "red", "mat") if w not in fw]
    assert len(words) >= 4
    for m in (2, 4):
        sent = " ".join(words[:m])
        _, scores = Meteor15().compute_score({"0": [sent]}, {"0": [sent]})
        assert scores[0] == pytest.approx(1.0 - GAMMA * (1.0 / m) ** BETA, abs=1e-12)
    _, z = Meteor15().compute_score({"0": ["dog runs"]}, {"0": ["qqq zzz"]})
    assert z[0] == 0.0
    # the synonym stage runs from the port's own copy of the bundled table
    gts = {"0": ["a big dog"]}
    _, s_exact = Meteor().compute_score(gts, {"0": ["a big dog"]})
    _, s_syn = Meteor().compute_score(gts, {"0": ["a large dog"]})
    _, s_none = Meteor().compute_score(gts, {"0": ["a qqq dog"]})
    assert s_none[0] < s_syn[0] < s_exact[0]
    assert Path(_DATA_DIR).parent.parent.name == "openviic_tpu_torch"
