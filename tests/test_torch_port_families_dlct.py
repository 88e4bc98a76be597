"""DLCT (``configs/dlct_fixed.yaml``: ``DLCTTransformer``,
``GeometricDualFeatureEmbedding``, ``DualCollaborativeLevelEncoder``) in
the port against the JAX package at f32 on the CPU: the shared cases of
``tests/torch_port_families.py`` on its four streams (their tolerances are
stated there; the encoder's is 2e-4, its box embedding's trig) and its
weights' JAX names.  Its own parts (masks, positions, the encoder without
the trig embedding, the bucket-padded grid, the layer kernels) are in
``tests/test_torch_port_families_dlct_parts.py``."""

import numpy as np
import pytest

from tests.torch_port_families import (  # noqa: F401  (collected in this module)
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
    return make_family("dlct")


def test_dlct_weights_carry_under_their_jax_names(family):
    """The JAX names region_<i>, grid_<i>, region2grid_<i>, grid2region_<i>
    land in the port's four stacks; the projections, fc_gs and both
    LayerNorms keep their names."""
    model = family.port_model
    assert model.vision_embedding.region_proj.weight.shape == (16, 13)
    assert model.vision_embedding.grid_proj.weight.shape == (16, 11)
    assert model.encoder.fc_gs.weight.shape == (2, 8)  # d_g = d_model / heads
    for stack in ("region", "grid", "region2grid", "grid2region"):
        assert len(getattr(model.encoder, stack)) == 1
        key = f"params/encoder/{stack}_0/mhatt/attention/fc_q/kernel"
        np.testing.assert_array_equal(
            getattr(model.encoder, stack)[0].mhatt.attention.fc_q.weight.detach().numpy(),
            family.flat[key].T)
    for name in ("layer_norm_region", "layer_norm_grid", "fc_gs"):
        assert any(k.startswith(f"params/encoder/{name}/") for k in family.flat)
