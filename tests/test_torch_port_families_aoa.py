"""Attention on Attention (``configs/attention_on_attention.yaml``: the
gate in the encoder's attention and in both of the decoder's) in the port
against the JAX package at f32 on the CPU: the shared cases of
``tests/torch_port_families.py`` (their tolerances are stated there), the
gate's weights and order, and the whole-layer step kernels, which do not
implement the gate and so bypass every AoA layer, as in the JAX package:
zero calls, and the decode equal to the one without the flag."""

import numpy as np
import pytest
import torch

from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.decoding import beam_search
from openviic_tpu_torch.models.attention import MultiHeadAttention
from tests.helpers import attention_config
from tests.test_torch_port_support import make_features
from tests.torch_port_families import (  # noqa: F401  (collected in this module)
    count_layer_kernels,
    make_family,
    port_decode,
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
    return make_family("aoa")


def test_aoa_gates_every_attention(family):
    model = family.port_model
    gated = [m for m in model.modules() if isinstance(m, MultiHeadAttention)]
    assert gated and all(m.use_aoa for m in gated)
    assert model.decoder.layers[0].enc_attn.informative_attention.weight.shape == (16, 32)
    assert "params/decoder/layer_1/self_attn/gated_attention/bias" in family.flat
    assert not any(layer._kernel_layer() for layer in model.decoder.layers)


def test_aoa_gate_follows_the_residual():
    """informative(x) * sigmoid(gated(x)) of x = [queries, LayerNorm(queries
    + attention)], computed here by hand."""
    mha = MultiHeadAttention(ConfigNode(attention_config(use_aoa=True))).eval()
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 3, 16, generator=gen)
    kv = torch.randn(2, 4, 16, generator=gen)
    with torch.no_grad():
        out = mha(q, kv, kv)
        res = torch.nn.functional.layer_norm(q + mha.attention(q, kv, kv), (16,),
                                             mha.layer_norm.weight, mha.layer_norm.bias, 1e-5)
        x = torch.cat([q, res], dim=-1)
        want = mha.informative_attention(x) * torch.sigmoid(mha.gated_attention(x))
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("path", ["resident_kernel", "fused_step"])
def test_whole_layer_kernels_bypass_aoa(family, monkeypatch, path):
    set_pallas(monkeypatch, False)
    feats = make_features(3, seed=6)
    if path == "resident_kernel":
        want = port_decode(family, feats)
        calls = count_layer_kernels(monkeypatch)
        got = port_decode(family, feats, resident_kernel=True)
    else:
        want = port_decode(family, feats, beam_resident=False)
        monkeypatch.setenv("OPENVIIC_FUSED_STEP", "1")
        calls = count_layer_kernels(monkeypatch)
        got = port_decode(family, feats, beam_resident=False)
    assert calls == {"resident_layer_step": [], "fused_layer_step": []}
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_attention_kernel_runs_under_aoa(family, monkeypatch):
    """``attn_kernel`` keeps the beam-select attention for AoA layers (the
    JAX package allows it): one call a layer and step."""
    import openviic_tpu_torch.models.attention as port_attention

    set_pallas(monkeypatch, False)
    calls = []
    real = port_attention.beam_select_attention
    monkeypatch.setattr(port_attention, "beam_select_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    beam_search(family.port_model, {"region_features": torch.from_numpy(make_features(2))},
                beam_size=3, attn_kernel=True, early_exit=False)
    assert len(calls) == len(family.port_model.decoder.layers) * family.vocab.max_caption_length
