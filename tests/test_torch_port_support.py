"""Shared set-up of the PyTorch port's CPU parity tests, and tests of the
port's host-side pieces (config, vocab, batch collation, weight carry).

A parity case builds the flagship architecture at a small width twice, in
the JAX package and in the port, with the same weights: drawn from a seed
with numpy in the JAX parameter layout and carried into the port through
``openviic_tpu_torch.compat.from_jax``."""

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from openviic_tpu.builders import build_model as build_jax_model
from openviic_tpu_torch.builders import build_model as build_port_model
from openviic_tpu_torch.compat.from_jax import load_jax_params, state_dict_from_jax
from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.data import Instance, InstanceList, Vocab
from tests.helpers import model_config

D_FEATURE = 13


def make_vocab(size: int = 120, max_len: int = 12) -> Vocab:
    specials = ["<pad>", "<bos>", "<eos>", "<unk>"]
    return Vocab(specials + [f"w{i}" for i in range(size - len(specials))], max_len)


def make_features(bs: int, n_regions: int = 6, seed: int = 0) -> np.ndarray:
    """(bs, n_regions, D_FEATURE) f32; image 0's last region row is zero
    padding, which the padding mask must flag."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(bs, n_regions, D_FEATURE)).astype(np.float32)
    feats[0, -1] = 0.0
    return feats


def make_captions(vocab: Vocab, bs: int, n_words: int = 4, seed: int = 0) -> np.ndarray:
    """(bs, max_len) int32: <bos>, n_words random words, then <pad>."""
    rng = np.random.default_rng(seed)
    tokens = np.full((bs, vocab.max_caption_length), vocab.padding_idx, np.int32)
    tokens[:, 0] = vocab.bos_idx
    tokens[:, 1 : 1 + n_words] = rng.integers(4, len(vocab), size=(bs, n_words))
    return tokens


def random_params(jax_model, vocab: Vocab, seed: int, eos_gain: float = 1.0,
                  feature_key: str = "region_features", d_feature: int = D_FEATURE):
    """Flat {"params/a/b": array} drawn with numpy in the JAX layout, over
    the parameters ``jax_model.init`` makes for ``feature_key`` features.
    ``eos_gain`` scales the head's <eos> column so that beams finish early."""
    features = np.random.default_rng(0).normal(size=(2, 6, d_feature)).astype(np.float32)
    batch = {feature_key: features, "caption_tokens": make_captions(vocab, 2)}
    template = jax_model.init(jax.random.PRNGKey(0), batch)
    rng = np.random.default_rng(seed)
    flat = {}
    for key, leaf in traverse_util.flatten_dict(template, sep="/").items():
        shape = np.shape(leaf)
        if key.endswith("scale"):
            value = 1.0 + 0.1 * rng.normal(size=shape)
        elif key.endswith("bias"):
            value = 0.1 * rng.normal(size=shape)
        elif key.endswith("kernel"):
            value = rng.normal(size=shape) / np.sqrt(shape[0])
        else:
            value = rng.normal(size=shape)
        flat[key] = value.astype(np.float32)
    flat["params/decoder/fc/kernel"][:, vocab.eos_idx] *= eos_gain
    return flat


def make_pair(vocab: Vocab, seed: int = 0, eos_gain: float = 1.0,
              architecture: str = "StandardTransformerUsingRegion", d_feature: int = D_FEATURE):
    """(jax_model, jax_params, port_model) at the test width, same weights;
    the port model is f32 on the CPU."""
    config = model_config(architecture=architecture, d_feature=d_feature)
    jax_model = build_jax_model(config, vocab)
    key = "grid_features" if architecture == "StandardTransformerUsingGrid" else "region_features"
    flat = random_params(jax_model, vocab, seed, eos_gain, feature_key=key, d_feature=d_feature)
    port_model = build_port_model(ConfigNode(config.to_dict()), vocab, device="cpu")
    load_jax_params(port_model, flat)
    jax_params = traverse_util.unflatten_dict(flat, sep="/")
    return jax_model, jax_params, port_model


def serving_config(checkpoint_path, architecture: str = "StandardTransformerUsingRegion",
                   d_feature: int = D_FEATURE) -> dict:
    """A serving config (``MODEL``, ``TRAINING``) as a dict at the test
    width, its checkpoints under ``checkpoint_path``."""
    return {
        "MODEL": model_config(architecture=architecture, d_feature=d_feature).to_dict(),
        "TRAINING": {"CHECKPOINT_PATH": str(checkpoint_path), "EVALUATING_BEAM_SIZE": 3},
    }


def write_checkpoints(root, jax_vocab, architecture: str = "StandardTransformerUsingRegion",
                      d_feature: int = D_FEATURE, seed: int = 7, eos_gain: float = 2.0):
    """The same weights (drawn by ``random_params`` over ``model.init``'s
    parameters, no training) as a JAX package checkpoint under
    ``root/jax/<NAME>`` and as the port's under ``root/port/<NAME>``, each
    beside the JAX ``vocab.bin`` of ``jax_vocab``.  Returns (the JAX
    config, the port's config), whose ``TRAINING.CHECKPOINT_PATH`` lead
    there."""
    import pickle

    from openviic_tpu.config import ConfigNode as JaxConfigNode
    from openviic_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint
    from openviic_tpu_torch.data.vocab import load_vocab
    from openviic_tpu_torch.training.checkpoint import save_checkpoint

    configs = {}
    for side in ("jax", "port"):
        configs[side] = serving_config(root / side, architecture, d_feature)
        run_dir = root / side / configs[side]["MODEL"]["NAME"]
        run_dir.mkdir(parents=True)
        with open(run_dir / "vocab.bin", "wb") as f:
            pickle.dump(jax_vocab, f)
    jax_config, port_config = JaxConfigNode(configs["jax"]), ConfigNode(configs["port"])
    jax_model = build_jax_model(jax_config.MODEL, jax_vocab)
    key = "grid_features" if architecture == "StandardTransformerUsingGrid" else "region_features"
    flat = random_params(jax_model, jax_vocab, seed, eos_gain, feature_key=key,
                         d_feature=d_feature)
    jax_dir = root / "jax" / jax_config.MODEL.NAME
    jax_save_checkpoint(str(jax_dir / "best_model.ckpt"),
                        {"params": traverse_util.unflatten_dict(flat, sep="/"), "opt_state": {},
                         "step": 0, "rng": jax.random.key(0)}, {"epoch": 0})
    port_dir = root / "port" / port_config.MODEL.NAME
    port_model = build_port_model(port_config.MODEL, load_vocab(port_dir / "vocab.bin"),
                                  device="cpu")
    load_jax_params(port_model, flat)
    save_checkpoint(str(port_dir / "best_model.ckpt"), port_model,
                    {"step": 0, "generator": torch.Generator().manual_seed(0)}, {"epoch": 0})
    return jax_config, port_config


def test_weight_carry_matches_every_key():
    vocab = make_vocab()
    jax_model = build_jax_model(model_config(d_feature=D_FEATURE), vocab)
    flat = random_params(jax_model, vocab, seed=0)
    port_model = build_port_model(
        ConfigNode(model_config(d_feature=D_FEATURE).to_dict()), vocab, device="cpu"
    )
    state = state_dict_from_jax(flat, port_model)
    assert set(state) == set(port_model.state_dict())
    # Dense kernels are (in, out) in JAX and (out, in) in the port; the head
    # becomes (V, D), one row per vocab id
    np.testing.assert_array_equal(
        state["decoder.fc.weight"].numpy(), flat["params/decoder/fc/kernel"].T
    )
    assert state["decoder.fc.weight"].shape == (len(vocab), 16)
    np.testing.assert_array_equal(
        state["encoder.layers.1.mhatt.layer_norm.weight"].numpy(),
        flat["params/encoder/layer_1/mhatt/layer_norm/scale"],
    )


@pytest.mark.parametrize("change", ["extra", "missing"])
def test_weight_carry_rejects_unmatched_keys(change):
    vocab = make_vocab()
    jax_model = build_jax_model(model_config(d_feature=D_FEATURE), vocab)
    flat = random_params(jax_model, vocab, seed=0)
    port_model = build_port_model(
        ConfigNode(model_config(d_feature=D_FEATURE).to_dict()), vocab, device="cpu"
    )
    if change == "extra":
        flat["params/decoder/extra/kernel"] = np.zeros((2, 2), np.float32)
    else:
        del flat["params/encoder/layer_0/pwff/fc1/bias"]
    with pytest.raises(KeyError):
        state_dict_from_jax(flat, port_model)


def test_config_loader_reads_a_shipped_yaml_like_the_jax_package():
    from openviic_tpu.config import get_config as jax_get_config
    from openviic_tpu_torch.config import get_config

    path = "configs/standard_transformer_using_region.yaml"
    assert get_config(path).to_dict() == jax_get_config(path).to_dict()


def test_vocab_decode_drops_specials_and_stops_at_eos():
    vocab = make_vocab(size=10)
    ids = np.array([[1, 4, 0, 5, 2, 6], [7, 8, 9, 3, 4, 4]])
    assert vocab.decode_caption(ids) == ["w0 w1", "w3 w4 w5 w0 w0"]
    assert vocab.decode_caption(ids[:1], join_words=False) == [["w0", "w1"]]


def test_instance_list_pads_rows_to_fixed_sizes():
    items = [
        Instance(region_features=np.ones((3, 2), np.float32), image_id=1),
        Instance(region_features=np.ones((5, 2), np.float32), image_id=2),
    ]
    batch = InstanceList(items, pad_sizes={"region_features": 8})
    assert batch["region_features"].shape == (2, 8, 2)
    assert batch["region_features"][0, 3:].sum() == 0
    assert set(batch.arrays()) == {"region_features", "image_id"}
    with pytest.raises(ValueError):
        InstanceList(items, pad_sizes={"region_features": 4})


def test_build_model_is_seeded_and_defaults_to_eval():
    vocab = make_vocab()
    config = ConfigNode(model_config(d_feature=D_FEATURE).to_dict())
    a = build_port_model(config, vocab, device="cpu", seed=3)
    b = build_port_model(config, vocab, device="cpu", seed=3)
    c = build_port_model(config, vocab, device="cpu", seed=4)
    assert not a.training
    for (name, pa), pb, pc in zip(a.state_dict().items(), b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.decoder.fc.weight, c.decoder.fc.weight)
    # the pad row of the token embedding starts at zero
    assert a.decoder.word_emb.embedding.weight[vocab.padding_idx].abs().sum() == 0
