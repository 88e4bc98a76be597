"""The augmented-memory transformer (``configs/augmented_memory_transformer.yaml``:
``MeshedMemoryTransformer`` over ``Encoder`` with
``AugmentedMemoryScaledDotProductAttention``, and a plain ``Decoder``) in
the port against the JAX package at f32 on the CPU: the shared cases of
``tests/torch_port_families.py`` (their tolerances are stated there), the
memory slots' carry and their promotion of K and V to f32 at bf16, and the
whole-layer step kernels on its plain decoder (their bars stated in
``check_resident_kernel`` and ``check_fused_step``).  The bf16 attention is
held to JAX's within 1e-2 (bf16 rounding of the projections and of the
output; the f32 slots and softmax are the same on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from openviic_tpu.config import ConfigNode as JaxConfigNode
from openviic_tpu.models.attention import AugmentedMemoryScaledDotProductAttention as JaxMemory
from openviic_tpu_torch.compat.from_jax import state_dict_from_jax, torch_name
from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.models.attention import AugmentedMemoryScaledDotProductAttention
from openviic_tpu_torch.models.initializers import initialize
from tests.helpers import attention_config
from tests.torch_port_families import (  # noqa: F401  (collected in this module)
    check_fused_step,
    check_resident_kernel,
    make_family,
    set_pallas,
    test_beam_decode_matches_jax,
    test_encoder_matches_jax,
    test_pipeline_and_scst_step_take_the_family,
    test_step_decode_matches_teacher_forced_and_jax,
    test_teacher_forced_log_probs_match_jax,
    test_xe_loss_and_gradients_match_jax,
)

BF16_ATOL = 1e-2


@pytest.fixture(scope="module")
def family():
    return make_family("augmented_memory")


def test_memory_slots_carry_untransposed(family):
    key = "params/encoder/layer_0/mhatt/attention/m_k"
    assert torch_name(key) == ("encoder.layers.0.mhatt.attention.m_k", False)
    slots = family.port_model.encoder.layers[0].mhatt.attention.m_k
    assert slots.shape == (1, 4, 16)
    np.testing.assert_array_equal(slots.detach().numpy(), family.flat[key])


def test_memory_slots_initialise_as_jax_does():
    """N(0, 1/d_k) and N(0, 1/m), drawn by ``initialize`` from its generator."""
    cfg = dict(attention_config("AugmentedMemoryScaledDotProductAttention"), MEMORY=400)
    att = AugmentedMemoryScaledDotProductAttention(ConfigNode(cfg))
    initialize(att, torch.Generator().manual_seed(0))
    d_k = cfg["D_KEY"]
    assert abs(att.m_k.std().item() - 1 / d_k) < 0.1 / d_k
    assert abs(att.m_v.std().item() - 1 / 400) < 0.1 / 400


@pytest.mark.parametrize("pallas", [False, True], ids=["eager", "pallas"])
def test_bf16_attention_promotes_like_jax(monkeypatch, pallas):
    """At bf16 the f32 slots make K and V f32 in both packages; under
    ``OPENVIIC_PALLAS`` the port hands the kernel q, k and v in f32, as
    the JAX kernel casts them, and its f32 output reaches the output
    projection."""
    set_pallas(monkeypatch, pallas)
    cfg = attention_config("AugmentedMemoryScaledDotProductAttention")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, cfg["D_MODEL"])).astype(np.float32)
    mask = np.zeros((2, 1, 1, 5), bool)
    mask[1, ..., -1] = True
    jax_att = JaxMemory(JaxConfigNode(cfg))
    params = jax_att.init(jax.random.PRNGKey(0), x, x, x)
    params = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.bfloat16), params)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jax_att.apply(params, xb, xb, xb, attention_mask=jnp.asarray(mask))
    att = AugmentedMemoryScaledDotProductAttention(ConfigNode(cfg))
    flat = {k: np.asarray(v, np.float32)
            for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    att.load_state_dict(state_dict_from_jax(flat, att))
    att = att.to(torch.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    with torch.no_grad():
        got = att(xt, xt, xt, attention_mask=torch.from_numpy(mask))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)  # bf16, or f32 under the flag
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=BF16_ATOL * np.abs(np.asarray(want, np.float32)).max(), rtol=0)


def test_resident_kernel_matches_jax(family, monkeypatch):
    check_resident_kernel(family, monkeypatch)


def test_fused_step_matches_jax(family, monkeypatch):
    check_fused_step(family, monkeypatch)
