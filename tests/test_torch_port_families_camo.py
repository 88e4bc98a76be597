"""CAMO (``configs/camo_transformer.yaml``: ``CamoTransformer``,
``CrossAttentionMultiLevelEncoder`` with its single-head encoder attention)
in the port against the JAX package at f32 on the CPU: the shared cases of
``tests/torch_port_families.py`` (their tolerances are stated there), and
the whole-layer step kernels on its plain decoder (their bars stated in
``check_resident_kernel`` and ``check_fused_step``)."""

import pytest
import torch

from openviic_tpu_torch.builders import build_model
from openviic_tpu_torch.config import ConfigNode
from tests.test_torch_port_support import make_features, make_vocab
from tests.torch_port_families import (  # noqa: F401  (collected in this module)
    check_fused_step,
    check_resident_kernel,
    family_config,
    make_family,
    test_beam_decode_matches_jax,
    test_encoder_matches_jax,
    test_pipeline_and_scst_step_take_the_family,
    test_step_decode_matches_teacher_forced_and_jax,
    test_teacher_forced_log_probs_match_jax,
    test_xe_loss_and_gradients_match_jax,
)


@pytest.fixture(scope="module")
def family():
    return make_family("camo")


def test_camo_weights_carry_under_their_jax_names(family):
    model = family.port_model
    assert model.encoder.self_attn.attention.fc_q.weight.shape == (8, 16)  # one head of d_k 8
    for name in ("mlp1", "mlp2", "self_attn"):
        assert any(k.startswith(f"params/encoder/{name}/") for k in family.flat)
    assert model.encoder.mlp1.weight.shape == (16, 48)


def test_camo_needs_its_three_layers():
    """The hard-coded unpack of three layer outputs raises for other
    depths, as the JAX package's does."""
    config = family_config("camo")
    config["ENCODER"]["LAYERS"] = 2
    model = build_model(ConfigNode(config), make_vocab(), device="cpu")
    with pytest.raises(ValueError):
        model.encoder_forward({"region_features": torch.from_numpy(make_features(2))})


def test_resident_kernel_matches_jax(family, monkeypatch):
    check_resident_kernel(family, monkeypatch)


def test_fused_step_matches_jax(family, monkeypatch):
    check_fused_step(family, monkeypatch)
