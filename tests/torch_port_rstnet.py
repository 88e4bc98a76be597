"""Shared set-up of the RSTNet parity tests (``tests/test_torch_port_rstnet*.py``):
``configs/rstnet_fixed.yaml``'s model at the test width (``tests/helpers.py``:
d_model 16, 2 heads, d_ff 32, two standard decoder layers and the adaptive
one), its frozen language model of hidden 16 over a vocab of ``LM_VOCAB``
ids, with the HF-family backbone (``PRETRAINED_NAME`` set: 4 layers of 8
heads, as the JAX package builds it offline) or the mini backbone (one
layer of 2 heads), in ``token`` or ``prefix`` signal mode.  The JAX model
and the port's share weights drawn with numpy in the JAX layout
(``random_params``) and carried through ``compat.from_jax``."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import torch
from flax import traverse_util

from openviic_tpu.builders import build_model as build_jax_model
from openviic_tpu.config import ConfigNode as JaxConfigNode
from openviic_tpu_torch.builders import build_model as build_port_model
from openviic_tpu_torch.compat.from_jax import load_jax_params, torch_name
from openviic_tpu_torch.config import ConfigNode
from tests.helpers import D_MODEL, attention_config, model_config
from tests.test_torch_port_support import make_vocab, random_params

LM_VOCAB = 150  # the language model's own vocab, past the caption vocab's 120 ids
LM_HIDDEN = 16
PRETRAINED = "vinai/phobert-base"  # names the family; nothing is read or fetched


def rstnet_model(pretrained: bool = True, mode: str = "token", dropout: float = 0.1,
                 architecture: str = "PhoBERTModel", max_len: int = 12, **model_kwargs) -> dict:
    """The MODEL tree: ``model_config`` with the adaptive decoder, its
    ``ADAPTIVE_ATTENTION`` and ``LANGUAGE_MODEL``; every DROPOUT at
    ``dropout``."""
    config = model_config(decoder="AdaptiveDecoder", **model_kwargs).to_dict()
    config["DECODER"]["ADAPTIVE_ATTENTION"] = {
        "SELF_ATTENTION": attention_config("AdaptiveScaledDotProductAttention",
                                           can_be_stateful=True),
        "ENC_ATTENTION": attention_config("AdaptiveScaledDotProductAttention"),
    }
    config["DECODER"]["LANGUAGE_MODEL"] = {
        "SIGNAL_MODE": mode, "ARCHITECTURE": architecture,
        "PRETRAINED_NAME": PRETRAINED if pretrained else None, "HIDDEN_SIZE": LM_HIDDEN,
        "D_MODEL": D_MODEL, "MAX_LEN": max_len, "VOCAB_SIZE": LM_VOCAB, "PADDING_IDX": 0,
        "BACKBONE_LAYERS": 1, "BACKBONE_HEADS": 2, "ATTENTION": attention_config(),
    }

    def walk(node):
        if isinstance(node, dict):
            return {k: (dropout if k == "DROPOUT" else walk(v)) for k, v in node.items()}
        return node
    return walk(config)


def make_rstnet(pretrained: bool = True, mode: str = "token", seed: int = 0,
                eos_gain: float = 1.0, **config):
    """The JAX model, its parameters (flat and as a tree) and the port's
    model with the same weights, f32 on the CPU."""
    vocab = make_vocab()
    model = rstnet_model(pretrained, mode, **config)
    jax_model = build_jax_model(JaxConfigNode(model), vocab)
    flat = random_params(jax_model, vocab, seed, eos_gain, shapes_only=True)
    port_model = load_jax_params(build_port_model(ConfigNode(model), vocab, device="cpu"), flat)
    return SimpleNamespace(vocab=vocab, config=model, flat=flat, jax_model=jax_model,
                           jax_params=traverse_util.unflatten_dict(flat, sep="/"),
                           port_model=port_model)


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


def is_backbone(jax_key: str) -> bool:
    return "/backbone/" in jax_key


def assert_grads_close(model, want: dict, tol: float) -> dict:
    """Every trainable leaf's gradient within ``tol`` of its max-abs, or of
    the largest gradient where its own is zero but for rounding (the
    language model's one-key softmax in ``token`` mode gives its query and
    key projections none); the backbone's JAX gradients are exactly zero
    (``stop_gradient``) and the port's parameters there get none, as the
    unused vocab head of the language model gets none.  Returns {key:
    error}."""
    named = dict(model.named_parameters())
    largest = max(float(np.abs(g).max()) for g in want.values())
    errors = {}
    for key, ref in want.items():
        name, transpose = torch_name(key)
        if is_backbone(key):
            assert not np.any(ref), key
            assert named[name].grad is None and not named[name].requires_grad, key
            continue
        if named[name].grad is None:  # unused (the vocab head): JAX's is zero
            assert not np.any(ref), key
            continue
        got = named[name].grad.numpy()
        ref = ref.T if transpose else ref
        scale = float(np.abs(ref).max())
        if scale < 1e-3 * largest:
            scale = largest
        errors[key] = float(np.abs(got - ref).max()) / scale
    worst = sorted(errors.items(), key=lambda kv: -kv[1])[:5]
    assert all(err <= tol for err in errors.values()), worst
    return errors
