"""``openviic_tpu_torch.serving.CaptioningPipeline.caption_features`` on the
CPU: fixed-size batches with a padded tail, captions made of vocab words,
and the same captions as the JAX package's beam search on the same weights
(bf16 compute is the pipeline's default; this runs it at f32)."""

import jax.numpy as jnp
import numpy as np
import torch

from openviic_tpu.decoding import beam_search as jax_beam_search
from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.serving import CaptioningPipeline
from tests.helpers import model_config
from tests.test_torch_port_support import D_FEATURE, make_pair, make_vocab


def _features(n, seed):
    """Images with 4 to 6 regions (rows are bucket-padded to 8)."""
    rng = np.random.default_rng(seed)
    return [
        {"region_features": rng.normal(size=(int(rng.integers(4, 7)), D_FEATURE)).astype(np.float32)}
        for _ in range(n)
    ]


def _pipeline(vocab, head_kernel, **kwargs):
    jax_model, jax_params, port_model = make_pair(vocab, seed=5, eos_gain=6.0)
    config = ConfigNode({
        "MODEL": model_config(d_feature=D_FEATURE).to_dict(),
        "TRAINING": {"EVALUATING_BEAM_SIZE": 3, "DECODE_HEAD_KERNEL": head_kernel},
    })
    pipe = CaptioningPipeline.from_state_dict(config, vocab, state_dict=port_model.state_dict(),
                                              batch_size=4, device="cpu", **kwargs)
    return pipe, jax_model, jax_params


def test_caption_features_pads_the_tail_and_matches_jax():
    vocab = make_vocab()
    pipe, jax_model, jax_params = _pipeline(vocab, head_kernel=True, use_bf16=False)
    images = _features(6, seed=0)  # one full batch of 4 and a tail of 2
    captions, ids = pipe.caption_features(images, return_ids=True)
    assert len(captions) == 6 and ids.shape == (6, vocab.max_caption_length)
    assert pipe.searcher.steps > 0
    for caption in captions:
        assert all(w in vocab.stoi and w not in vocab.specials for w in caption.split())

    # the JAX decode of the same images, padded as the pipeline pads them
    padded = np.zeros((6, 8, D_FEATURE), np.float32)
    for i, image in enumerate(images):
        padded[i, : len(image["region_features"])] = image["region_features"]
    want, _ = jax_beam_search(jax_model, jax_params, {"region_features": jnp.asarray(padded)},
                              beam_size=3, beam_resident=True, head_kernel=True)
    np.testing.assert_array_equal(ids, np.asarray(want))
    assert captions == vocab.decode_caption(np.asarray(want))


def test_bf16_pipeline_serves_both_selection_branches():
    vocab = make_vocab()
    images = _features(5, seed=1)
    kernel_pipe, _, _ = _pipeline(vocab, head_kernel=True)
    fast_pipe, _, _ = _pipeline(vocab, head_kernel=False)
    assert next(kernel_pipe.model.parameters()).dtype == torch.bfloat16
    kernel_caps = kernel_pipe.caption_features(images)
    fast_caps = fast_pipe.caption_features(images)
    assert len(kernel_caps) == len(fast_caps) == 5
    assert all(isinstance(c, str) for c in kernel_caps + fast_caps)
