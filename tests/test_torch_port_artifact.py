"""The committed trained artifact (``saved_models/realistic_d512_bench/``)
through the port, against the JAX package on the CPU: the loader with the
JAX stack blocked, the config, the caption preprocessing and encoding, and
the f32 beam-5 decode of all 150 test images (tokens equal)."""

import collections
import itertools
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
from flax import traverse_util

from openviic_tpu.config import ConfigNode as JaxConfigNode
from openviic_tpu.data.datasets import FeatureDataset
from openviic_tpu.data.preprocess import preprocess_caption as jax_preprocess
from openviic_tpu.decoding import beam_search
from openviic_tpu.evaluation import Cider
from openviic_tpu_torch.artifact import (
    ARTIFACT_DIR, artifact_cider, artifact_config, collapse_repeats, load_trained_artifact)
from openviic_tpu_torch.compat.from_jax import torch_name
from openviic_tpu_torch.data.datasets import caption_instance
from openviic_tpu_torch.data.preprocess import get_tokenizer, preprocess_caption
from openviic_tpu_torch.data.vocab import Vocab, load_vocab
from openviic_tpu_torch.serving import CaptioningPipeline
from tests.test_torch_port_isolation import BLOCKED

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = str(ROOT / "scripts")

_BLOCKED_LOAD = """
import json, sys


class BlockImports:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {blocked!r}:
            raise ModuleNotFoundError(f"import of {{name}} is blocked")
        return None


sys.meta_path.insert(0, BlockImports())
from openviic_tpu_torch.artifact import load_trained_artifact

a = load_trained_artifact(device="cpu")
v = a["vocab"]
print(json.dumps({{
    "vocab": [v.itos, dict(v.stoi), v.padding_idx, v.bos_idx, v.eos_idx, v.unk_idx,
              v.max_caption_length, v.specials],
    "config": a["config"].to_dict(),
    "params": {{k: float(t.double().sum()) for k, t in a["state_dict"].items()}},
    "feats": [list(a["feats"].shape), float(a["feats"].astype("float64").sum())],
    "ids": a["ids"], "refs": a["refs"],
    "blocked_loaded": sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r}),
}}))
"""


@pytest.fixture(scope="module")
def jax_artifact(tmp_path_factory):
    sys.path.insert(0, SCRIPTS)  # the JAX loader imports its config from there
    try:
        from trained_artifact import load_trained_artifact as jax_load

        return jax_load(str(tmp_path_factory.mktemp("bench_trained")))
    finally:
        sys.path.remove(SCRIPTS)


@pytest.fixture(scope="module")
def port_artifact():
    return load_trained_artifact(device="cpu")


def test_artifact_loads_with_the_jax_stack_blocked(jax_artifact):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_LOAD.format(blocked=BLOCKED)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.splitlines()[-1])
    assert got["blocked_loaded"] == []
    want = jax_artifact["vocab"]
    assert got["vocab"] == [want.itos, dict(want.stoi), want.padding_idx, want.bos_idx,
                            want.eos_idx, want.unk_idx, want.max_caption_length, want.specials]
    assert len(want.itos) == 7094 and want.max_caption_length == 30
    assert got["feats"][0] == [150, 40, 1024]
    assert got["feats"][1] == float(jax_artifact["feats"].astype(np.float64).sum())
    assert got["ids"] == jax_artifact["ids"]
    assert got["refs"] == jax_artifact["refs"]
    assert len(got["params"]) == 132


def test_vocab_pickle_refuses_other_globals(tmp_path):
    vocab = load_vocab(ARTIFACT_DIR / "vocab.bin")
    assert isinstance(vocab, Vocab) and len(vocab) == 7094
    bad = tmp_path / "bad.bin"
    bad.write_bytes(pickle.dumps({"order": collections.OrderedDict()}))
    with pytest.raises(pickle.UnpicklingError, match="OrderedDict"):
        load_vocab(bad)
    evil = tmp_path / "evil.bin"
    evil.write_bytes(b"cos\nsystem\n(S'true'\ntR.")
    with pytest.raises(pickle.UnpicklingError, match="os.system|posix.system"):
        load_vocab(evil)
    plain = tmp_path / "plain.bin"
    plain.write_bytes(pickle.dumps([1, 2]))
    with pytest.raises(pickle.UnpicklingError, match="not a Vocab"):
        load_vocab(plain)


def test_config_equals_shared_config(tmp_path):
    sys.path.insert(0, SCRIPTS)
    try:
        from compare_training_vs_reference import shared_config
    finally:
        sys.path.remove(SCRIPTS)
    want = shared_config("/nonexistent", str(tmp_path), "bench", d_model=512, heads=8,
                         layers=3, d_ff=2048).to_dict()
    got = artifact_config().to_dict()
    assert got["MODEL"] == want["MODEL"]
    assert got["TRAINING"] == {k: want["TRAINING"][k] for k in got["TRAINING"]}
    # the keys the decode and the XE step read
    assert {"LEARNING_RATE", "WARMUP", "EVALUATING_BEAM_SIZE"} <= set(got["TRAINING"])


def test_weights_and_features_equal_the_jax_loader(jax_artifact, port_artifact):
    flat = traverse_util.flatten_dict(jax_artifact["params"], sep="/")
    state = port_artifact["state_dict"]
    assert len(flat) == len(state) == 132
    for key, value in flat.items():
        name, transpose = torch_name(key)
        want = np.asarray(value).T if transpose else np.asarray(value)
        np.testing.assert_array_equal(state[name].numpy(), want, err_msg=key)
    np.testing.assert_array_equal(port_artifact["feats"], jax_artifact["feats"])
    assert port_artifact["ids"] == jax_artifact["ids"]


def test_caption_preprocessing_and_instances_equal_jax(jax_artifact, port_artifact, tmp_path):
    """preprocess_caption, encode_caption and the caption instance against
    the JAX package's, on every reference of the first 30 images (the
    instances through the JAX FeatureDataset itself)."""
    jvocab, vocab, refs = jax_artifact["vocab"], port_artifact["vocab"], port_artifact["refs"]
    with pytest.raises(NotImplementedError):
        get_tokenizer("pyvi")
    for caption in [c for i in port_artifact["ids"] for c in refs[i]] + [
            "Một “người” (đàn ông), đang: đi! bộ? trên [phố]; 3/4 $5 & *x*. it's"]:
        tokens = preprocess_caption(caption, None)
        assert tokens == jax_preprocess(caption, None)
        if len(tokens) <= vocab.max_caption_length - 2:
            np.testing.assert_array_equal(vocab.encode_caption(tokens),
                                          jvocab.encode_caption(tokens))
    with pytest.raises(IndexError):  # too long, as in the JAX package
        vocab.encode_caption(["x"] * vocab.max_caption_length)

    ids = port_artifact["ids"][:30]
    images = [{"id": n, "file_name": f"{i}.jpg"} for n, i in enumerate(ids)]
    anns = [{"image_id": n, "caption": c} for n, i in enumerate(ids) for c in refs[i]]
    (tmp_path / "features").mkdir()
    for n in range(len(ids)):
        np.save(tmp_path / "features" / f"{n}.npy",
                {"region_features": np.full((2, 3), n, np.float32)}, allow_pickle=True)
    (tmp_path / "test.json").write_text(json.dumps({"images": images, "annotations": anns}))
    config = JaxConfigNode({"FEATURE_PATH": {"FEATURES": str(tmp_path / "features")}})
    dataset = FeatureDataset(str(tmp_path / "test.json"), jvocab, config)
    assert len(dataset) == len(anns)
    for k, ann in enumerate(anns):
        want = dataset[k]
        got = caption_instance(vocab, preprocess_caption(ann["caption"], None),
                               region_features=np.full((2, 3), ann["image_id"], np.float32))
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_f32_beam5_decode_equals_jax_tokens(jax_artifact, port_artifact):
    """All 150 test images in one batch, beam 5, f32, beam-resident: the
    port's CaptioningPipeline gives the JAX beam_search's tokens, and the
    same CIDEr as the JAX package's bench computes (repeats collapsed)."""
    feats = jax_artifact["feats"]
    outs, _ = beam_search(jax_artifact["model"], jax_artifact["params"],
                          {"region_features": jnp.asarray(feats)}, beam_size=5, out_size=1,
                          beam_resident=True)
    want = np.asarray(outs).reshape(len(feats), -1)
    a = port_artifact
    pipe = CaptioningPipeline.from_state_dict(a["config"], a["vocab"], state_dict=a["state_dict"],
                                              beam_size=5, batch_size=150, use_bf16=False,
                                              device="cpu")
    captions, got = pipe.caption_features([{"region_features": f} for f in a["feats"]],
                                          return_ids=True)
    assert got.shape == want.shape == (150, 30)
    np.testing.assert_array_equal(got, want)
    jcaps = jax_artifact["vocab"].decode_caption(want, join_words=False)
    gens = {i: [" ".join(k for k, _ in itertools.groupby(c))] for i, c in zip(a["ids"], jcaps)}
    jcider = float(Cider().compute_score({i: a["refs"][i] for i in a["ids"]}, gens)[0])
    assert artifact_cider(captions, a["ids"], a["refs"]) == jcider
    assert 0.05 < jcider < 0.5


def test_collapse_repeats():
    assert collapse_repeats("a a b b b a c") == "a b a c"
    assert collapse_repeats("") == ""
