"""The port's native word segmenter (``openviic_tpu_torch/data/rdr_segmenter.py``,
the tokenizer ``rdr``) against the JAX package's binding of the same
engine: the strings of ``tests/test_rdr_segmenter.py`` segmented alike with
and without a lexicon, JOIN / SPLIT rules and an SCRDR model written by
the test; ``preprocess_caption(..., "rdr")``; the port's own ``g++`` build
into a build directory when the committed library is not there; the
refusal when no library loads."""

import pytest

import openviic_tpu_torch.data.rdr_segmenter as rdr
from openviic_tpu.data.preprocess import preprocess_caption as jax_preprocess_caption
from openviic_tpu.data.rdr_segmenter import RDRSegmenter as JaxRDRSegmenter
from openviic_tpu_torch.data.preprocess import preprocess_caption
from openviic_tpu_torch.data.rdr_segmenter import RDRSegmenter
from tests.test_rdr_segmenter import SCRDR_MODEL

LEXICON = "học sinh\nsinh học\nđàn ông\nđi bộ\nbóng đá\nkhoa học máy tính\n"
RULES = "# exceptions over the base segmentation\nJOIN * con mèo\nSPLIT những sinh_học\n"
STRINGS = ["học sinh đi bộ", "khoa học máy tính và bóng đá", "xin chào thế giới",
           "một con mèo", "những sinh học", "ngành sinh học", "chiếc xe máy",
           "một con mèo hoang", "đang đi bộ", ""]
# tests/test_rdr_segmenter.py's expected segmentations, after add_word("xe máy")
EXPECTED = {
    "rules": {"một con mèo": "một con_mèo", "những sinh học": "những sinh học",
              "chiếc xe máy": "chiếc xe_máy"},
    "scrdr": {"một con mèo hoang": "một con mèo hoang", "đang đi bộ": "đang đi_bộ",
              "ngành sinh học": "ngành sinh_học"},
    "bare": {"học sinh đi bộ": "học sinh đi bộ"},
}


def _files(tmp_path, case: str) -> dict:
    """The constructor's paths for ``case``: nothing, a lexicon, lexicon and
    rules (``tests/test_rdr_segmenter.py``'s ``segmenter``), or a lexicon
    and the SCRDR model (its ``scrdr_segmenter``)."""
    paths = {}
    if case != "bare":
        lexicon = tmp_path / "lexicon.txt"
        lexicon.write_text("sinh học\n" if case == "scrdr" else LEXICON)
        paths["lexicon_path"] = str(lexicon)
    if case == "rules":
        rules = tmp_path / "rules.txt"
        rules.write_text(RULES)
        paths["rules_path"] = str(rules)
    if case == "scrdr":
        model = tmp_path / "model.rdr"
        model.write_text(SCRDR_MODEL)
        paths["model_path"] = str(model)
    return paths


def _fresh(monkeypatch, committed=None, build_dir=None):
    """The binding's load state reset (tried once per process), with the
    committed library and the build directory replaced where given."""
    for name, value in (("_tried", False), ("_lib", None), ("_lib_path", None)):
        monkeypatch.setattr(rdr, name, value)
    monkeypatch.setattr(RDRSegmenter, "_default", None)
    if committed is not None:
        monkeypatch.setattr(rdr, "COMMITTED", committed)
    if build_dir is not None:
        monkeypatch.setattr(rdr, "BUILD_DIR", build_dir)


@pytest.mark.parametrize("case", ["bare", "lexicon", "rules", "scrdr"])
def test_segmentations_equal_jax(tmp_path, case):
    """Every string segmented as the JAX binding segments it, before and
    after ``add_word``; the SCRDR model's node count; the expected
    segmentations of ``tests/test_rdr_segmenter.py``."""
    paths = _files(tmp_path, case)
    got, want = RDRSegmenter(**paths), JaxRDRSegmenter(**paths)
    for words in ([], ["xe máy"]):
        for w in words:
            got.add_word(w)
            want.add_word(w)
        assert [got.tokenize(s) for s in STRINGS] == [want.tokenize(s) for s in STRINGS]
    for sentence, segmented in EXPECTED.get(case, {}).items():
        assert got.tokenize(sentence) == segmented
    if case == "scrdr":
        assert got.load_scrdr(paths["model_path"]) == want.load_scrdr(paths["model_path"]) == 7
        bad = tmp_path / "bad.rdr"
        bad.write_text('\tobject.tag == "B" : object.conclusion = "B"\n')
        with pytest.raises(ValueError):
            got.load_scrdr(str(bad))


def test_preprocess_caption_with_rdr(tmp_path, monkeypatch):
    """The ``rdr`` tokenizer reads ``OPENVIIC_RDR_LEXICON`` once, at its
    first use, and gives the JAX package's tokens."""
    lexicon = tmp_path / "lex.txt"
    lexicon.write_text("đàn ông\n")
    monkeypatch.setenv("OPENVIIC_RDR_LEXICON", str(lexicon))
    monkeypatch.setattr(RDRSegmenter, "_default", None)
    monkeypatch.setattr(JaxRDRSegmenter, "_default", None)
    caption = "Một người đàn ông (đang) đi bộ, trên đường!"
    tokens = preprocess_caption(caption, "rdr")
    assert tokens == jax_preprocess_caption(caption, "rdr")
    assert tokens[:3] == ["một", "người", "đàn_ông"]
    assert RDRSegmenter._default is not None


def test_builds_its_own_library_when_the_committed_one_is_missing(tmp_path, monkeypatch):
    """Without the committed library the binding compiles
    ``native/rdr_segmenter.cpp`` into its build directory, named by the
    source's hash, writes nothing into ``native/``, and segments as the
    JAX binding does."""
    native_dir = rdr.SOURCE.parent
    before = {p.name: p.stat().st_mtime_ns for p in native_dir.iterdir()}
    build_dir = tmp_path / "build"
    _fresh(monkeypatch, committed=tmp_path / "missing.so", build_dir=build_dir)
    paths = _files(tmp_path, "rules")
    got = RDRSegmenter(**paths)
    assert rdr.library_path().parent == build_dir
    assert rdr.library_path().name.startswith("rdr_segmenter-")
    want = JaxRDRSegmenter(**paths)
    assert [got.tokenize(s) for s in STRINGS] == [want.tokenize(s) for s in STRINGS]
    assert {p.name: p.stat().st_mtime_ns for p in native_dir.iterdir()} == before


def test_refuses_when_no_library_loads(tmp_path, monkeypatch):
    """No committed library and no source to build: the segmenter and the
    ``rdr`` tokenizer raise (no pyvi fallback)."""
    _fresh(monkeypatch, committed=tmp_path / "missing.so", build_dir=tmp_path / "build")
    monkeypatch.setattr(rdr, "SOURCE", tmp_path / "missing.cpp")
    with pytest.raises(RuntimeError, match="no native segmenter loads"):
        RDRSegmenter()
    with pytest.raises(RuntimeError, match="pyvi"):
        preprocess_caption("một con mèo", "rdr")
    assert not (tmp_path / "build").exists()
