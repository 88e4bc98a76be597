"""The committed trained flagship, ``saved_models/realistic_d512_bench/``:
the port's counterpart of ``scripts/trained_artifact.py``.

The artifact holds the d512 StandardTransformerUsingRegion's parameters as
f16 (``params_f16.npz``, 132 flat ``params/...`` keys), the pickled JAX
``Vocab`` (``vocab.bin``: 7 094 tokens, ``max_caption_length`` 30), the
held-out test split's region features (``test_features.npz``: 150 images of
16-40 regions of 1024-d f16) and their references (``test_refs.json``, 5
captions an image).  The loader reads it without the JAX package or
PyYAML and writes nothing there."""

from __future__ import annotations

import itertools
import json
import os
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from openviic_tpu_torch.config import ConfigNode

ARTIFACT_DIR = Path(__file__).resolve().parent.parent / "saved_models" / "realistic_d512_bench"


def artifact_config(name: str = "bench", d_model: int = 512, heads: int = 8, layers: int = 3,
                    d_ff: int = 2048) -> ConfigNode:
    """The artifact's model config, with the ``TRAINING`` keys that the
    decode and the XE step read: the ``MODEL`` subtree and those keys of
    ``scripts/compare_training_vs_reference.py::shared_config(..., d_model=512,
    heads=8, layers=3, d_ff=2048)``, which built the model the artifact was
    exported from."""
    d_head = d_model // heads
    attn = {
        "ARCHITECTURE": "ScaledDotProductAttention",
        "HEAD": heads, "D_MODEL": d_model, "D_KEY": d_head, "D_VALUE": d_head,
        "D_FF": d_ff, "D_FEATURE": 128, "MEMORY": 8,
        "USE_AOA": False, "CAN_BE_STATEFUL": False, "DROPOUT": 0.1,
    }
    model = {
        "ARCHITECTURE": "StandardTransformerUsingRegion",
        "NAME": name,
        "DEVICE": "cpu",
        "VISION_EMBEDDING": {"ARCHITECTURE": "FeatureEmbedding", "D_FEATURE": 1024,
                             "D_MODEL": d_model, "DROPOUT": 0.1},
        "ENCODER": {"ARCHITECTURE": "Encoder", "D_MODEL": d_model, "LAYERS": layers,
                    "TRIGNOMETRIC_EMBEDDING": False, "SELF_ATTENTION": dict(attn)},
        "DECODER": {
            "ARCHITECTURE": "Decoder", "D_MODEL": d_model, "LAYERS": layers,
            "ATTENTION": {"D_MODEL": d_model, "N_ENCODER_LAYERS": layers,
                          "SELF_ATTENTION": dict(attn, CAN_BE_STATEFUL=True),
                          "ENC_ATTENTION": dict(attn)},
            "TEXT_EMBEDDING": {"ARCHITECTURE": "UsualEmbedding", "D_MODEL": d_model,
                               "D_EMBEDDING": d_model, "WORD_EMBEDDING": None,
                               "WORD_EMBEDDING_CACHE": None, "DROPOUT": 0.1},
        },
    }
    training = {"LEARNING_RATE": 1.0, "RL_LEARNING_RATE": 5e-6, "WARMUP": 100,
                "TRAINING_BEAM_SIZE": 3, "EVALUATING_BEAM_SIZE": 3}
    return ConfigNode({"MODEL": model, "TRAINING": training})


def pad_regions(raw: List[np.ndarray]) -> np.ndarray:
    """Per-image (n_i, d) features -> (images, max n_i, d) f32, zero-padded:
    the vision embedding's padding mask flags the all-zero rows."""
    feats = np.zeros((len(raw), max(a.shape[0] for a in raw), raw[0].shape[1]), np.float32)
    for i, a in enumerate(raw):
        feats[i, : a.shape[0]] = a
    return feats


def load_trained_artifact(artifact_dir=ARTIFACT_DIR, device="cuda") -> Dict[str, Any]:
    """Load the artifact.  Returns ``config``, ``vocab``, ``state_dict`` (f32,
    on the CPU), ``model`` (f32, eval mode, on ``device``), ``feats`` (the
    test features as f32, zero-padded to the most regions, 40), ``ids`` and
    ``refs`` ({image id: reference captions}); raises FileNotFoundError when
    the directory is absent."""
    from openviic_tpu_torch.builders import build_model
    from openviic_tpu_torch.compat.from_jax import state_dict_from_jax
    from openviic_tpu_torch.data.vocab import load_vocab

    artifact_dir = Path(artifact_dir)
    if not artifact_dir.is_dir():
        raise FileNotFoundError(artifact_dir)
    config = artifact_config()
    vocab = load_vocab(artifact_dir / "vocab.bin")
    model = build_model(config.MODEL, vocab, device="cpu")
    with np.load(artifact_dir / "params_f16.npz") as z:
        flat = {key: z[key].astype(np.float32) for key in z.files}
    state_dict = state_dict_from_jax(flat, model)
    model.load_state_dict(state_dict, strict=True)
    with np.load(artifact_dir / "test_features.npz") as z:
        ids = list(z.files)
        feats = pad_regions([z[i].astype(np.float32) for i in ids])
    refs = None
    if os.path.isfile(artifact_dir / "test_refs.json"):
        with open(artifact_dir / "test_refs.json") as f:
            refs = json.load(f)
    return {"config": config, "vocab": vocab, "state_dict": state_dict,
            "model": model.to(device), "feats": feats, "ids": ids, "refs": refs}


def collapse_repeats(caption: str) -> str:
    """A caption with consecutive repeated words kept once, as the JAX
    package's bench scores its trained decode (``bench.py:196-206``)."""
    return " ".join(word for word, _ in itertools.groupby(caption.split()))


def artifact_cider(captions: List[str], ids: List[str], refs: Dict[str, List[str]]) -> float:
    """Test CIDEr of one caption per image, repeats collapsed."""
    from openviic_tpu_torch.evaluation import Cider

    gens = {i: [collapse_repeats(c)] for i, c in zip(ids, captions)}
    return float(Cider().compute_score({i: refs[i] for i in ids}, gens)[0])
