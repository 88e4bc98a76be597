"""The port's binding of the native C++ scorers (``openviic_tpu_torch.native``)
against its Python scorers, at the bar and on the cases of
tests/test_native.py (1e-9; the PTB tokenizer string for string), and
``compute_scores`` with ``OPENVIIC_NATIVE=0`` and ``=1``; a stale library
keeps the Python METEOR; a committed library that is missing or does not
load is replaced by the port's own build from ``native/openviic_native.cpp``,
never by a write into ``native/``.  Skipped only where no library loads."""

import json
import os
import shutil

import numpy as np
import pytest

from openviic_tpu_torch import native
from openviic_tpu_torch.artifact import ARTIFACT_DIR
from openviic_tpu_torch.evaluation import Cider, MeteorClassic, PTBTokenizer, compute_scores
from openviic_tpu_torch.evaluation import _metrics
from openviic_tpu_torch.evaluation.meteor15 import Meteor15

TOL = 1e-9

GTS = {
    "0": ["một người đàn ông đi bộ trên đường", "người đàn ông trên phố"],
    "1": ["hai đứa trẻ chơi bóng", "trẻ em đá bóng trên sân"],
    "2": ["con mèo nằm trên ghế"],
}
RES = {
    "0": ["một người đàn ông đi trên đường"],
    "1": ["hai đứa trẻ đá bóng"],
    "2": ["con chó nằm trên ghế"],
}


@pytest.fixture()
def lib():
    if not native.available():
        pytest.skip("no native library loads (committed or built from source)")
    return native._load()


def _equal(got, want):
    got_score, got_scores = got
    want_score, want_scores = want
    assert abs(got_score - want_score) <= TOL
    np.testing.assert_allclose(got_scores, want_scores, rtol=0, atol=TOL)


def _artifact_pairs(n_images=40):
    """Each of the artifact's first test images: its first reference as the
    caption, the others as its references (real Vietnamese text)."""
    with open(ARTIFACT_DIR / "test_refs.json") as f:
        refs = json.load(f)
    ids = sorted(refs)[:n_images]
    return {i: refs[i][1:] for i in ids}, {i: [refs[i][0]] for i in ids}


@pytest.mark.parametrize("train_df", [False, True], ids=["batch_df", "train_df"])
def test_native_cider_matches_python(lib, train_df):
    train = None
    if train_df:
        train = {"a": ["một con mèo trên ghế"], "b": ["hai đứa trẻ chơi bóng"]}
    _equal(native.NativeCider(gts=train).compute_score(GTS, RES),
           Cider(train).compute_score(GTS, RES))


def test_native_cider_with_token_list_df(lib):
    """The SCST reward's df corpus: token lists, so only unigrams carry df."""
    gts, res = _artifact_pairs()
    train = {str(i): refs[0].split() for i, refs in enumerate(gts.values())}
    _equal(native.NativeCider(gts=train).compute_score(gts, res),
           Cider(train).compute_score(gts, res))


def test_native_classic_meteor_matches_python(lib):
    gts = {
        "0": ["the cat sat on the mat"],
        "1": ["the cats are running fast", "cats run quickly"],
        "2": ["x y z"],
    }
    res = {"0": ["the cat sat on the mat"], "1": ["the cat is run"], "2": ["a b c"]}
    _equal(native.NativeMeteor().compute_score(gts, res), MeteorClassic().compute_score(gts, res))


def test_native_meteor15_matches_python(lib):
    """Exact, stem and synonym stages ('big' / 'large' share a bundled
    synset), on tests/test_native.py's random segments."""
    rng = np.random.default_rng(5)
    words = ["the", "cats", "are", "running", "dog", "walks", "a", "on",
             "mat", "red", "big", "large", "street", "road"]
    gts, res = {}, {}
    for i in range(30):
        def sent():
            return " ".join(rng.choice(words, size=int(rng.integers(3, 10))))
        gts[str(i)] = [sent() for _ in range(int(rng.integers(1, 4)))]
        res[str(i)] = [sent()]
    _equal(native.NativeMeteor15().compute_score(gts, res), Meteor15().compute_score(gts, res))


def test_native_meteor15_long_segment_goes_to_python(lib):
    """A segment past the native aligner's 128 tokens: the batch is scored
    by the Python scorer whole."""
    gts = {"0": [" ".join(f"t{i}" for i in range(140))], "1": ["the cat"]}
    res = {"0": [" ".join(f"t{i}" for i in range(3, 133))], "1": ["the cat"]}
    _equal(native.NativeMeteor15().compute_score(gts, res), Meteor15().compute_score(gts, res))


def test_native_ptb_matches_python(lib):
    lines = [
        "A man, with a dog (brown), walks.",
        "He isn't here; she's gone...",
        "Numbers: 1,000 and $5 & 50%!",
    ] + list(_artifact_pairs(10)[1].values())[0]
    want = PTBTokenizer().tokenize({i: [line] for i, line in enumerate(lines)})
    got = native.ptb_tokenize_batch(lines)
    assert got == [want[i][0] for i in range(len(lines))]


def test_compute_scores_native_equals_python(lib, monkeypatch):
    gts, res = _artifact_pairs()
    monkeypatch.setenv("OPENVIIC_NATIVE", "1")
    kinds = {str(m): type(m) for m in _metrics()}
    assert kinds["CIDEr"] is native.NativeCider and kinds["METEOR"] is native.NativeMeteor15
    got, got_per = compute_scores(gts, res)
    monkeypatch.setenv("OPENVIIC_NATIVE", "0")
    kinds = {str(m): type(m) for m in _metrics()}
    assert kinds["CIDEr"] is Cider and kinds["METEOR"] is Meteor15
    want, want_per = compute_scores(gts, res)
    assert set(got) == set(want) == {"BLEU", "METEOR", "ROUGE", "CIDEr"}
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=TOL)
        np.testing.assert_allclose(got_per[key], want_per[key], rtol=0, atol=TOL)


class _StaleLibrary:
    """The loaded library without its later METEOR 1.5 entry points."""

    MISSING = ("ov_meteor15_score_syn", "ov_meteor15_score_par")

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        if name in self.MISSING:
            raise AttributeError(name)
        return getattr(self._lib, name)


def test_stale_library_keeps_python_meteor(lib, monkeypatch):
    monkeypatch.setenv("OPENVIIC_NATIVE", "1")
    monkeypatch.setattr(native, "_load", lambda: _StaleLibrary(lib))
    assert native.meteor15_entry_point() in _StaleLibrary.MISSING  # the bundled synonyms
    kinds = {str(m): type(m) for m in _metrics()}
    assert kinds["METEOR"] is Meteor15 and kinds["CIDEr"] is native.NativeCider
    gts, res = _artifact_pairs(10)
    got, _ = compute_scores(gts, res)
    monkeypatch.setenv("OPENVIIC_NATIVE", "0")
    want, _ = compute_scores(gts, res)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def build_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("native_build")


@pytest.mark.parametrize("committed", ["missing", "unloadable"])
def test_port_builds_its_own_library_from_source(build_dir, tmp_path, monkeypatch, committed):
    """Without a loadable committed library the port compiles
    native/openviic_native.cpp into its own build directory, loads that
    and scores as the Python scorers; native/ is left untouched."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ here")
    before = {p.name: p.stat().st_mtime_ns for p in native.SOURCE.parent.iterdir()}
    fake = tmp_path / "libopenviic_native.so"
    if committed == "unloadable":
        fake.write_bytes(b"not a shared library")
    monkeypatch.setattr(native, "COMMITTED", fake)
    monkeypatch.setattr(native, "BUILD_DIR", build_dir)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_path", None)
    assert native.available()
    assert native.library_path() == native.built_path()
    assert native.library_path().parent == build_dir
    _equal(native.NativeCider().compute_score(GTS, RES), Cider().compute_score(GTS, RES))
    assert {p.name: p.stat().st_mtime_ns for p in native.SOURCE.parent.iterdir()} == before
    assert not [p for p in os.listdir(build_dir) if p.endswith(".tmp")]
