"""Pretrained word vectors in the PyTorch port (``data/word_embedding.py``,
``builders.build_word_embedding``, ``Vocab.load_word_embeddings`` and
``from_config``, the unpickler of ``load_vocab``, ``UsualEmbedding`` and
``LSTMTextEmbedding`` with vectors, ``compat/migrate.py``) against the JAX
package on the CPU, f32.

The vector files are written here from a seed (GloVe text, fastText's
header line, a zip served through a ``file://`` URL): nothing is
downloaded.  Bars: vectors and caches equal; the embeddings' forwards 1e-5
(the weights drawn in the JAX layout and carried through
``compat.from_jax``); the flagship's beam decode tokens equal, log-probs
within 1e-4 (``tests/test_torch_port_moe_lstm.py``'s bar)."""

import copy
import pickle
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from openviic_tpu.builders import META_WORD_EMBEDDING as JAX_META_WORD_EMBEDDING
from openviic_tpu.builders import build_model as build_jax_model
from openviic_tpu.config import ConfigNode as JaxConfigNode
from openviic_tpu.data import Vocab as JaxVocab
from openviic_tpu.data.word_embedding import WordEmbedding as JaxWordEmbedding
from openviic_tpu.decoding import beam_search as jax_beam_search
from openviic_tpu.models.text_embedding import LSTMTextEmbedding as JaxLSTMEmbedding
from openviic_tpu.models.text_embedding import UsualEmbedding as JaxUsualEmbedding
from openviic_tpu_torch.builders import META_WORD_EMBEDDING, build_word_embedding
from openviic_tpu_torch.builders import build_model as build_port_model
from openviic_tpu_torch.compat import migrate
from openviic_tpu_torch.compat.from_jax import load_jax_params
from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.data import vocab as vocab_module
from openviic_tpu_torch.data.vocab import Vocab, load_vocab
from openviic_tpu_torch.data.word_embedding import WordEmbedding, unk_init
from openviic_tpu_torch.decoding import beam_search
from openviic_tpu_torch.models.text_embedding import LSTMTextEmbedding, UsualEmbedding
from openviic_tpu_torch.serving import CaptioningPipeline
from tests.conftest import make_dataset_config
from tests.helpers import model_config
from tests.test_migrate import _reference_vocab_pickle
from tests.test_torch_port_moe_lstm import _jax, _module_params, _torch, assert_decodes_equal
from tests.test_torch_port_support import make_features, make_vocab, random_params

ATOL = 1e-5
BEAM = 3
# tests/test_torch_port_decode_kernels.py's f32 step bar for the resident kernel
RESIDENT_STEP_ATOL = 0.05
NAMES = ("PhoW2VSyllable100", "PhoW2VWord100")  # 100-d, the narrowest registered


@pytest.fixture()
def glove_cache(tmp_path):
    (tmp_path / "test_vectors.txt").write_text(
        "người 0.1 0.2 0.3\n"
        "mèo 0.4 0.5 0.6\n"
        "chó -0.1 -0.2 -0.3\n"
    )
    return tmp_path


class _TestVectors(WordEmbedding):
    url = None
    filename = "test_vectors.txt"
    dim = 3


class _JaxTestVectors(JaxWordEmbedding):
    url = None
    filename = "test_vectors.txt"
    dim = 3


def write_vectors(cache, name: str, words, seed: int, extra: int = 0) -> np.ndarray:
    """A seeded vector file of the registered ``name``'s file name and
    width over ``words`` and ``extra`` more; returns its rows."""
    cls = META_WORD_EMBEDDING.get(name)
    words = list(words) + [f"extra{i}" for i in range(extra)]
    rows = np.random.default_rng(seed).normal(size=(len(words), cls.dim)).astype(np.float32)
    with open(cache / cls.filename, "w", encoding="utf-8") as f:
        for word, row in zip(words, rows):
            f.write(word + " " + " ".join(repr(float(x)) for x in row) + "\n")
    return rows


# -- JAX's five tests, on the port ----------------------------------------
def test_parse_and_lookup(glove_cache):
    we = _TestVectors(cache=str(glove_cache))
    assert len(we) == 3
    np.testing.assert_allclose(we["mèo"], [0.4, 0.5, 0.6], atol=1e-6)
    np.testing.assert_allclose(we["xyz"], [3.0, 3.0, 3.0])
    np.testing.assert_allclose(we["<pad>"], [0.0, 0.0, 0.0])
    np.testing.assert_allclose(we["<bos>"], [1.0, 1.0, 1.0])
    np.testing.assert_allclose(we["<eos>"], [2.0, 2.0, 2.0])
    jax_we = _JaxTestVectors(cache=str(glove_cache))
    for token in ("<p>", "<s>", "</s>", "<sos>", "xyz"):
        assert unk_init(token, 3).tolist() == jax_we[token].tolist()


def test_binary_cache_roundtrip(glove_cache):
    we1 = _TestVectors(cache=str(glove_cache))
    assert (glove_cache / "test_vectors.txt.npz").is_file()
    (glove_cache / "test_vectors.txt").unlink()
    we2 = _TestVectors(cache=str(glove_cache))
    np.testing.assert_allclose(we2["người"], we1["người"])


def test_fasttext_header_line(tmp_path):
    (tmp_path / "ft.vec").write_text("2 4\na 1 2 3 4\nb 5 6 7 8\n")

    class _FT(WordEmbedding):
        url = None
        filename = "ft.vec"
        dim = 4

    we = _FT(cache=str(tmp_path))
    assert len(we) == 2 and we.dim == 4
    np.testing.assert_allclose(we["b"], [5, 6, 7, 8])


def test_registered_names():
    names = ["PhoW2VSyllable100", "PhoW2VSyllable300", "PhoW2VWord100", "PhoW2VWord300",
             "EnFastText", "ViFastText"]
    build_word_embedding(ConfigNode({"WORD_EMBEDDING": None}))  # registers the classes
    for name in names:
        assert name in META_WORD_EMBEDDING
        port, jax_cls = META_WORD_EMBEDDING.get(name), JAX_META_WORD_EMBEDDING.get(name)
        assert (port.url, port.filename, port.dim) == (jax_cls.url, jax_cls.filename,
                                                       jax_cls.dim)


def test_vocab_load_word_embeddings(glove_cache, tiny_dataset_dir, tiny_vocab):
    vocab = Vocab.from_config(ConfigNode(make_dataset_config(tiny_dataset_dir).to_dict()))
    vocab.load_word_embeddings(_TestVectors(cache=str(glove_cache)))
    assert vocab.word_embeddings.shape == (len(vocab), 3)
    np.testing.assert_allclose(vocab.word_embeddings[vocab.stoi["mèo"]], [0.4, 0.5, 0.6])
    np.testing.assert_allclose(vocab.word_embeddings[vocab.padding_idx], 0.0)
    want = copy.copy(tiny_vocab)
    want.load_word_embeddings(_JaxTestVectors(cache=str(glove_cache)))
    np.testing.assert_array_equal(vocab.word_embeddings, want.word_embeddings)


# -- caches, downloads, gzip ----------------------------------------------
def test_npz_caches_cross_between_the_packages(tmp_path):
    """A cache either package wrote is the other's: the same keys, the
    vectors and words read back equal, gzip sources included."""
    import gzip

    for i, (writer, reader) in enumerate(((WordEmbedding, JaxWordEmbedding),
                                          (JaxWordEmbedding, WordEmbedding))):
        cache = tmp_path / f"cache{i}"
        cache.mkdir()
        with gzip.open(cache / "v.vec.gz", "wt", encoding="utf-8") as f:
            f.write("3 2\nmột 0.5 -1.25\nhai 2 3\nmột 9 9\n")  # a repeated word keeps its first

        def cls(base):
            return type("V", (base,), {"url": None, "filename": "v.vec.gz", "dim": 7})

        first = cls(writer)(cache=str(cache))
        assert first.dim == 2 and first["một"].tolist() == [0.5, -1.25]
        with np.load(cache / "v.vec.gz.npz", allow_pickle=True) as z:
            assert set(z.files) == {"vectors", "itos"}
        (cache / "v.vec.gz").unlink()
        second = cls(reader)(cache=str(cache))
        assert second.stoi == first.stoi
        np.testing.assert_array_equal(second.vectors, first.vectors)


def test_file_url_zip_download(tmp_path):
    """On a cache miss the port fetches a ``.zip`` URL (a ``file://`` one
    here) beside the vector file, extracts it and parses the file; the
    JAX module writes the archive under the text file's own name and then
    fails to parse it (kept as it is there).  Without a URL both raise
    ``FileNotFoundError`` naming where to put the file."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "vecs.txt").write_text("a 1 2\nb 3 4\n")
    with zipfile.ZipFile(src / "vecs.zip", "w") as zf:
        zf.write(src / "vecs.txt", "vecs.txt")
    url = (src / "vecs.zip").as_uri()
    attrs = {"url": url, "filename": "vecs.txt", "dim": 2}
    port = type("Z", (WordEmbedding,), attrs)(cache=str(tmp_path / "port"))
    assert port["b"].tolist() == [3.0, 4.0] and (tmp_path / "port" / "vecs.txt.npz").is_file()
    with pytest.raises(ValueError):
        type("Z", (JaxWordEmbedding,), attrs)(cache=str(tmp_path / "jax"))
    assert zipfile.is_zipfile(tmp_path / "jax" / "vecs.txt")
    for base in (WordEmbedding, JaxWordEmbedding):
        with pytest.raises(FileNotFoundError, match="No cached vectors at .*none.txt"):
            type("N", (base,), {"url": None, "filename": "none.txt", "dim": 2})(
                cache=str(tmp_path / "empty"))


# -- the vocab --------------------------------------------------------------
def vocab_config(root, cache, names) -> dict:
    cfg = make_dataset_config(root).to_dict()
    cfg["VOCAB"].update(WORD_EMBEDDING=names, WORD_EMBEDDING_CACHE=str(cache))
    return cfg


@pytest.mark.parametrize("names", [NAMES[0], list(NAMES)])
def test_from_config_with_word_embedding_matches_jax(tmp_path, tiny_dataset_dir, names):
    """``VOCAB.WORD_EMBEDDING`` (a name, or a list whose vectors sit side
    by side) gives JAX's ``word_embeddings``; the other download-bound
    keys still raise."""
    plain = Vocab.from_config(ConfigNode(make_dataset_config(tiny_dataset_dir).to_dict()))
    for i, name in enumerate(NAMES):
        write_vectors(tmp_path, name, plain.itos[4:-2], seed=i)  # some words lack a vector
    cfg = vocab_config(tiny_dataset_dir, tmp_path, names)
    got, want = Vocab.from_config(ConfigNode(cfg)), JaxVocab(JaxConfigNode(cfg))
    assert got.itos == want.itos
    assert got.word_embeddings.shape == (len(got), 100 * (1 if isinstance(names, str) else 2))
    np.testing.assert_array_equal(got.word_embeddings, want.word_embeddings)
    np.testing.assert_array_equal(got.word_embeddings[got.unk_idx], 3.0)  # unk_init
    cfg["VOCAB"]["USE_MAPPING"] = True
    with pytest.raises(NotImplementedError, match="USE_MAPPING"):
        Vocab.from_config(ConfigNode(cfg))


def test_jax_vocab_bin_with_vectors_loads_and_other_globals_are_refused(tmp_path,
                                                                         tiny_dataset_dir):
    """A JAX ``vocab.bin`` carrying ``word_embeddings`` (a pickled float32
    ndarray) loads through ``load_vocab``, at pickle protocols 2 to 5; a
    pickle naming any other global, a numpy one included, is refused."""
    write_vectors(tmp_path, NAMES[0], ["người", "mèo"], seed=3)
    want = JaxVocab(JaxConfigNode(vocab_config(tiny_dataset_dir, tmp_path, NAMES[0])))
    for protocol in (2, 4, 5):
        path = tmp_path / f"vocab{protocol}.bin"
        with open(path, "wb") as f:
            pickle.dump(want, f, protocol=protocol)
        got = load_vocab(path)
        assert got.itos == want.itos and got.stoi == want.stoi
        assert got.word_embeddings.dtype == np.float32
        np.testing.assert_array_equal(got.word_embeddings, want.word_embeddings)
    for evil in (np.random.RandomState(0), np.float64(1.0), print,
                 np.arange(3, dtype=object)):
        with open(tmp_path / "evil.bin", "wb") as f:
            pickle.dump(evil, f)
        with pytest.raises(pickle.UnpicklingError):
            load_vocab(tmp_path / "evil.bin")
    bad = copy.copy(want)
    bad.word_embeddings = np.zeros((2, 2), np.int64)
    with open(tmp_path / "bad.bin", "wb") as f:
        pickle.dump(bad, f)
    with pytest.raises(pickle.UnpicklingError, match="float32"):
        load_vocab(tmp_path / "bad.bin")
    assert ("numpy", "ndarray") in vocab_module._VocabUnpickler.ALLOWED_ARRAY


# -- the embeddings and the flagship ---------------------------------------
def vectors_vocab(tmp_path, name=NAMES[0]):
    """The test vocab with ``name``'s seeded vectors over every word (the
    specials take ``unk_init``'s rows)."""
    vocab = make_vocab()
    write_vectors(tmp_path, name, vocab.itos[4:], seed=5)
    vocab.load_word_embeddings(META_WORD_EMBEDDING.get(name)(cache=str(tmp_path)))
    return vocab


def embedding_node(tmp_path, architecture: str, name=NAMES[0]) -> dict:
    node = model_config().to_dict()["DECODER"]["TEXT_EMBEDDING"]
    node.update(ARCHITECTURE=architecture, WORD_EMBEDDING=name,
                WORD_EMBEDDING_CACHE=str(tmp_path), DROPOUT=0.0)
    return node


@pytest.mark.parametrize("architecture,jax_cls,port_cls", [
    ("UsualEmbedding", JaxUsualEmbedding, UsualEmbedding),
    ("LSTMTextEmbedding", JaxLSTMEmbedding, LSTMTextEmbedding)])
def test_embeddings_with_vectors_match_jax(tmp_path, architecture, jax_cls, port_cls):
    """Gather, then dropout, then ``proj`` (the LSTM's: gather, ``proj``,
    dropout, the LSTM) within 1e-5; the vectors are a buffer that no
    ``state_dict`` carries, so ``from_jax`` matches ``proj`` alone."""
    vocab = vectors_vocab(tmp_path)
    node = embedding_node(tmp_path, architecture)
    tokens = np.random.default_rng(2).integers(0, len(vocab), size=(3, 7)).astype(np.int32)
    jax_layer = jax_cls(JaxConfigNode(node), vocab)
    flat = _module_params(jax_layer, jnp.asarray(tokens))
    assert not any("embedding" in k for k in flat)
    layer = load_jax_params(port_cls(ConfigNode(node), vocab), flat).eval()
    assert "vectors" not in layer.state_dict()
    torch.testing.assert_close(layer.vectors, torch.from_numpy(vocab.word_embeddings))
    want, _ = jax.jit(jax_layer.apply)(traverse_util.unflatten_dict(flat, sep="/"),
                                       jnp.asarray(tokens))
    with torch.no_grad():
        got, _ = layer(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def flagship(tmp_path, vocab):
    config = model_config().to_dict()
    config["DECODER"]["TEXT_EMBEDDING"].update(WORD_EMBEDDING=NAMES[0],
                                               WORD_EMBEDDING_CACHE=str(tmp_path))
    jax_model = build_jax_model(JaxConfigNode(config), vocab)
    flat = random_params(jax_model, vocab, seed=7, eos_gain=2.0)
    port = build_port_model(ConfigNode(config), vocab, device="cpu")
    load_jax_params(port, flat)
    return config, jax_model, traverse_util.unflatten_dict(flat, sep="/"), port


def test_flagship_with_vectors_decodes_as_jax(tmp_path, monkeypatch):
    """The flagship with ``UsualEmbedding`` over pretrained vectors: the
    beam decode (f32, beam 3) gives JAX's tokens, log-probs within 1e-4,
    on the fast-select path and with the head and attention kernels (their
    plain versions here, JAX's Pallas kernels in interpret mode); the
    resident layer kernel's gate lets the model in, and its decode gives
    JAX's ``resident_kernel`` tokens (the Pallas kernel in interpret
    mode), each step's log-prob within the kernel's f32 bar (its operands
    rounded through bf16 on both sides, at values within rounding of a bf16
    boundary)."""
    from openviic_tpu_torch.decoding.beam_search import _supports_beam_resident

    for flag in ("OPENVIIC_PALLAS", "OPENVIIC_FUSED_STEP"):
        monkeypatch.delenv(flag, raising=False)
    vocab = vectors_vocab(tmp_path)
    _, jax_model, params, port = flagship(tmp_path, vocab)
    assert _supports_beam_resident(port)
    feats = {"region_features": make_features(3, seed=4)}
    for flags in ({}, {"head_kernel": True, "attn_kernel": True}):
        want = jax.jit(lambda p, b: jax_beam_search(jax_model, p, b, beam_size=BEAM,
                                                    out_size=BEAM, **flags))(params, _jax(feats))
        assert_decodes_equal(beam_search(port, _torch(feats), beam_size=BEAM, out_size=BEAM,
                                         **flags), want)
    want = jax_beam_search(jax_model, params, _jax(feats), beam_size=BEAM, out_size=BEAM,
                           resident_kernel=True)
    got = beam_search(port, _torch(feats), beam_size=BEAM, out_size=BEAM, resident_kernel=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=RESIDENT_STEP_ATOL,
                               rtol=0)


def test_bf16_decode_with_vectors_fails_in_jax_and_runs_in_the_port(tmp_path, monkeypatch):
    """At bf16 JAX's beam search over pretrained ``UsualEmbedding`` vectors
    raises a TypeError on the default, ``head_kernel`` and
    ``resident_kernel`` paths: the vectors are an f32 constant
    (``openviic_tpu/models/text_embedding.py:55-60``), so ``proj``'s output
    is f32 and meets the bf16 cache in ``dynamic_update_slice``.  The
    port's ``model.to(dtype)`` casts its ``vectors`` buffer, so its bf16
    decode runs, with the plain path's tokens on the head, attention and
    resident kernels' CPU versions too."""
    import jax.numpy as jnp

    for flag in ("OPENVIIC_PALLAS", "OPENVIIC_FUSED_STEP"):
        monkeypatch.delenv(flag, raising=False)
    vocab = vectors_vocab(tmp_path)
    _, jax_model, params, port = flagship(tmp_path, vocab)
    feats = {"region_features": make_features(3, seed=4)}
    for flags in ({}, {"head_kernel": True}, {"resident_kernel": True}):
        with pytest.raises(TypeError, match="dynamic_update_slice.*bfloat16, float32"):
            jax.jit(lambda p, b: jax_beam_search(
                jax_model, p, b, beam_size=BEAM, out_size=BEAM, compute_dtype=jnp.bfloat16,
                **flags))(params, _jax(feats))
    plain = beam_search(port, _torch(feats), beam_size=BEAM, out_size=BEAM,
                        compute_dtype=torch.bfloat16)
    assert np.isfinite(plain[1].float().numpy()).all()
    for flags in ({"head_kernel": True, "attn_kernel": True}, {"resident_kernel": True}):
        got = beam_search(port, _torch(feats), beam_size=BEAM, out_size=BEAM,
                          compute_dtype=torch.bfloat16, **flags)
        np.testing.assert_array_equal(got[0].numpy(), plain[0].numpy())


def test_raw_file_fallback_takes_rows_by_token_id_on_both_sides(tmp_path):
    """With ``TEXT_EMBEDDING.WORD_EMBEDDING`` set and no vectors in the
    vocab, JAX's ``UsualEmbedding`` gathers rows of the raw vector file by
    token id, in the file's word order, not the vocab's
    (``openviic_tpu/models/text_embedding.py:56-60``), and NaN past the
    file's last row: mirrored in the port, not fixed.  ``LSTMTextEmbedding``
    trains its own embedding then, on both sides."""
    vocab = make_vocab()
    rows = write_vectors(tmp_path, NAMES[0], reversed(vocab.itos[60:]), seed=6)
    assert len(rows) < len(vocab)
    node = embedding_node(tmp_path, "UsualEmbedding")
    tokens = np.array([[1, 5, 58, 59, 60, 119]], np.int32)
    jax_layer = JaxUsualEmbedding(JaxConfigNode(node), vocab)
    flat = _module_params(jax_layer, jnp.asarray(tokens))
    layer = load_jax_params(UsualEmbedding(ConfigNode(node), vocab), flat).eval()
    np.testing.assert_array_equal(layer.vectors[:len(rows)].numpy(), rows)
    want, _ = jax_layer.apply(traverse_util.unflatten_dict(flat, sep="/"), jnp.asarray(tokens))
    with torch.no_grad():
        got, _ = layer(torch.from_numpy(tokens).long())
    want = np.asarray(want)
    assert np.isnan(want[0, -2:]).all() and np.isfinite(want[0, :-2]).all()
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0, equal_nan=True)
    lstm_node = embedding_node(tmp_path, "LSTMTextEmbedding")
    assert "embedding" in dict(LSTMTextEmbedding(ConfigNode(lstm_node), vocab).named_children())
    lstm_flat = _module_params(JaxLSTMEmbedding(JaxConfigNode(lstm_node), vocab),
                               jnp.asarray(tokens))
    assert "params/embedding/embedding" in lstm_flat


def test_original_run_vectors_reach_the_model_and_the_pipeline(tmp_path):
    """An original-code run whose ``vocab.bin`` carries ``word_embeddings``
    (a torch tensor there): ``import_reference_checkpoint`` builds the
    model over them, writes them in the port's ``vocab.bin`` (a float32
    ndarray, which ``load_vocab`` admits), and the pipeline from there
    holds them and captions as the imported weights do."""
    run = tmp_path / "run"
    run.mkdir()
    _reference_vocab_pickle(run / "vocab.bin", n=30, with_embeddings=True)
    vocab = migrate.load_reference_vocab(str(run / "vocab.bin"))
    assert vocab.word_embeddings.dtype == np.float32
    config = model_config().to_dict()
    config["DECODER"]["TEXT_EMBEDDING"].update(WORD_EMBEDDING=NAMES[0])
    cfg = {"MODEL": config, "TRAINING": {"CHECKPOINT_PATH": str(tmp_path / "out"),
                                         "EVALUATING_BEAM_SIZE": 2},
           "DATASET": make_dataset_config(tmp_path).to_dict()}
    model = build_port_model(ConfigNode(config), vocab, device="cpu", seed=3)
    torch.save({"state_dict": {k: v.clone() for k, v in model.state_dict().items()}},
               run / "best_model.pth")
    report = migrate.import_reference_checkpoint(ConfigNode(cfg), str(run / "best_model.pth"),
                                                 device="cpu")
    assert report["missing"] == report["unused"] == []
    served = CaptioningPipeline(ConfigNode(cfg), use_bf16=False, device="cpu")
    np.testing.assert_array_equal(served.vocab.word_embeddings, vocab.word_embeddings)
    torch.testing.assert_close(served.model.decoder.word_emb.vectors,
                               torch.from_numpy(vocab.word_embeddings))
    images = [{"region_features": f} for f in make_features(2, seed=9)]
    direct = CaptioningPipeline.from_state_dict(ConfigNode(cfg), vocab,
                                                state_dict=model.state_dict(), use_bf16=False,
                                                device="cpu")
    assert served.caption_features(images) == direct.caption_features(images)
