"""The port's flagship model (StandardTransformerUsingRegion) against the JAX
package at float32 on the CPU, same weights: the teacher-forced forward,
the cached step decode, and the pieces of the beam-resident attention.

Tolerance 2e-4 on log-probs at non-pad caption positions (padded rows are
fully masked and NaN on both sides): the criterion of the JAX package's
own torch parity test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openviic_tpu.models.attention import _resolve_ancestry as jax_resolve_ancestry
from openviic_tpu.models.base import make_decode_cache as jax_make_decode_cache
from openviic_tpu_torch.models.attention import _resolve_ancestry
from openviic_tpu_torch.models.base import make_decode_cache
from tests.test_torch_port_support import make_captions, make_features, make_pair, make_vocab

ATOL = 2e-4


@pytest.fixture(scope="module")
def pair():
    vocab = make_vocab()
    jax_model, jax_params, port_model = make_pair(vocab, seed=0)
    return vocab, jax_model, jax_params, port_model


@pytest.mark.parametrize("seed", [0, 1])
def test_teacher_forced_log_probs_match_jax(pair, seed):
    vocab, jax_model, jax_params, port_model = pair
    feats = make_features(3, seed=seed)
    tokens = make_captions(vocab, 3, seed=seed)
    want = np.asarray(jax_model.apply(
        jax_params, {"region_features": jnp.asarray(feats), "caption_tokens": jnp.asarray(tokens)}
    ))
    with torch.no_grad():
        got = port_model({
            "region_features": torch.from_numpy(feats),
            "caption_tokens": torch.from_numpy(tokens).long(),
        }).numpy()
    keep = tokens != vocab.padding_idx
    assert got.shape == want.shape == (3, vocab.max_caption_length, len(vocab))
    np.testing.assert_allclose(got[keep], want[keep], atol=ATOL, rtol=0)


def test_decode_step_matches_teacher_forced_and_jax(pair):
    """Step t of the cached decode gives the teacher-forced log-probs at t,
    in the port, and equals the JAX decode_step."""
    vocab, jax_model, jax_params, port_model = pair
    feats = make_features(2, seed=3)
    tokens = make_captions(vocab, 2, n_words=4, seed=3)
    jbatch = {"region_features": jnp.asarray(feats)}
    memory, memory_mask = jax_model.apply(jax_params, jbatch, method=jax_model.encoder_forward)
    jcache = jax_make_decode_cache(jax_model.config.DECODER, vocab, 2)
    jcache = jax_model.apply(jax_params, jcache, memory, method=jax_model.prepare_cache)

    with torch.no_grad():
        tbatch = {"region_features": torch.from_numpy(feats)}
        tf = port_model(dict(tbatch, caption_tokens=torch.from_numpy(tokens).long())).numpy()
        tmem, tmask = port_model.encoder_forward(tbatch)
        cache = make_decode_cache(port_model.config.DECODER, vocab, 2)
        cache = port_model.prepare_cache(cache, tmem)
        for t in range(6):  # bos, 4 words, then a pad input
            step, cache = port_model.decode_step(t, torch.from_numpy(tokens[:, t : t + 1]).long(),
                                                 cache, tmask)
            jstep, jcache = jax_model.apply(
                jax_params, t, jnp.asarray(tokens[:, t : t + 1]), jcache, memory_mask,
                method=jax_model.decode_step,
            )
            np.testing.assert_allclose(step.numpy(), np.asarray(jstep), atol=ATOL, rtol=0,
                                       err_msg=f"step {t} vs JAX")
            if t < 5:
                np.testing.assert_allclose(step.numpy(), tf[:, t], atol=1e-4, rtol=0,
                                           err_msg=f"step {t} vs teacher-forced")


def test_resolve_ancestry_gathers_like_jax():
    rng = np.random.default_rng(0)
    bs, beam, L = 2, 3, 5
    cache = rng.normal(size=(bs * beam, L, 2, 4)).astype(np.float32)
    ancestry = rng.integers(0, beam, size=(bs, beam, L)).astype(np.int32)
    want = np.asarray(jax_resolve_ancestry(jnp.asarray(cache), jnp.asarray(ancestry)))
    got = _resolve_ancestry(torch.from_numpy(cache), torch.from_numpy(ancestry).long()).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mask_axis", ["q", "p"])
def test_beam_select_attention_matches_jax(pair, mask_axis):
    """attend_projected_beam_select (einsum form) against the JAX method on
    the same projected q/K/V, ancestry and position mask."""
    vocab, jax_model, jax_params, port_model = pair
    from openviic_tpu.models.attention import ScaledDotProductAttention as JaxSDPA

    cfg = jax_model.config.DECODER.ATTENTION.SELF_ATTENTION
    rng = np.random.default_rng(1)
    bs, beam, L, h, dk = 2, 3, 6, cfg.HEAD, cfg.D_KEY
    q = rng.normal(size=(bs * beam, 1, h, dk)).astype(np.float32)
    k = rng.normal(size=(bs * beam, L, h, dk)).astype(np.float32)
    v = rng.normal(size=(bs * beam, L, h, dk)).astype(np.float32)
    ancestry = rng.integers(0, beam, size=(bs, beam, L)).astype(np.int32)
    mask = rng.random(size=(bs * beam, 1, 1, L)) < 0.3
    mask[..., 0] = False  # position 0 (<bos>) is never masked
    params = jax_params["params"]["decoder"]["layer_0"]["self_attn"]["attention"]
    want = np.asarray(JaxSDPA(cfg).apply(
        {"params": params}, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(ancestry), jnp.asarray(mask), mask_axis,
        method=JaxSDPA.attend_projected_beam_select,
    ))
    attention = port_model.decoder.layers[0].self_attn.attention
    with torch.no_grad():
        got = attention.attend_projected_beam_select(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(ancestry).long(), torch.from_numpy(mask), mask_axis=mask_axis,
        ).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
