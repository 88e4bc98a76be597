"""The Meshed-Memory transformer (``configs/meshed_memory_transformer.yaml``:
``MultilevelEncoder`` with the augmented memory, ``MeshedDecoder``) in the
port against the JAX package at f32 on the CPU: the shared cases of
``tests/torch_port_families.py`` (their tolerances are stated there), the
gates' weights, the beam-resident decode's grouped cross-attention, and
``resident_kernel``, which fails in the JAX package on this decoder and
raises in the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openviic_tpu_torch.models.attention as port_attention
from openviic_tpu.decoding import beam_search as jax_beam_search
from openviic_tpu_torch.compat.from_jax import torch_name
from openviic_tpu_torch.decoding import beam_search
from openviic_tpu_torch.decoding.beam_search import _supports_beam_resident
from tests.test_torch_port_support import make_features
from tests.torch_port_families import (  # noqa: F401  (collected in this module)
    make_family,
    set_pallas,
    test_beam_decode_matches_jax,
    test_encoder_matches_jax,
    test_pipeline_and_scst_step_take_the_family,
    test_step_decode_matches_teacher_forced_and_jax,
    test_teacher_forced_log_probs_match_jax,
    test_xe_loss_and_gradients_match_jax,
)


@pytest.fixture(scope="module")
def family():
    return make_family("meshed_memory")


def test_level_gates_carry_under_their_jax_names(family):
    key = "params/decoder/layer_1/fc_alpha_0/kernel"
    assert torch_name(key) == ("decoder.layers.1.fc_alpha_0.weight", True)
    layer = family.port_model.decoder.layers[1]
    assert layer.n_levels == 2 and layer.fc_alpha_1.weight.shape == (16, 32)
    np.testing.assert_array_equal(layer.fc_alpha_0.weight.detach().numpy(), family.flat[key].T)


def test_beam_resident_decode_shares_each_level_per_image(family, monkeypatch):
    """Beam-resident mode, as in JAX: each level's cross K/V kept per image,
    (bs, N, n, h, d), read through the grouped attention."""
    set_pallas(monkeypatch, False)
    assert _supports_beam_resident(family.port_model)
    shapes = []
    real = port_attention.ScaledDotProductAttention.attend_cached_grouped

    def spy(self, queries, k, *args):
        shapes.append(tuple(k.shape))
        return real(self, queries, k, *args)
    monkeypatch.setattr(port_attention.ScaledDotProductAttention, "attend_cached_grouped", spy)
    beam_search(family.port_model, {"region_features": torch.from_numpy(make_features(2))},
                beam_size=3, early_exit=False)
    n_layers, L = len(family.port_model.decoder.layers), family.vocab.max_caption_length
    assert shapes == [(2, 6, 2, 8)] * (2 * n_layers * L)  # 2 levels a layer and step


def test_resident_kernel_raises_as_jax_fails(family, monkeypatch):
    set_pallas(monkeypatch, False)
    feats = make_features(2)
    with pytest.raises(ValueError, match="Size of label 'b'"):
        jax_beam_search(family.jax_model, family.jax_params,
                        {"region_features": jnp.asarray(feats)}, beam_size=3,
                        resident_kernel=True)
    with pytest.raises(ValueError, match="resident_kernel does not run MeshedDecoder"):
        beam_search(family.port_model, {"region_features": torch.from_numpy(feats)},
                    beam_size=3, resident_kernel=True)
