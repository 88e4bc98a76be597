"""DLCT's own parts in the port against the JAX package at f32 on the
CPU, on ``tests/torch_port_families.py``'s DLCT family: the visibility
masks (equal, on f32 boxes and on bf16 boxes, coordinates on the grid lines
k / 7 among them), the embedding's four masks (equal), the normalized
positions (1e-6), the encoder without the trig embedding at two levels
(1e-5: the shared case's 2e-4 with it is that embedding's sin/cos), the
grid stream bucket-padded from 49 to 56 rows (the encoder within 2e-4,
the beam decode's tokens equal and log-probs within 1e-4), the layer step
kernels on its plain decoder over its memory of regions and grid (the
bars of ``check_resident_kernel`` and ``check_fused_step``), and a bf16
decode with the boxes rounded."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openviic_tpu.models.geometry import get_combine_masks as jax_combine_masks
from openviic_tpu.models.geometry import get_grids_position as jax_grids_position
from openviic_tpu.models.positional import sinusoid_positional_embedding as jax_positions
from openviic_tpu_torch.models.geometry import get_combine_masks, get_grids_position
from openviic_tpu_torch.models.positional import sinusoid_positional_embedding
from tests.torch_port_families import (
    ENCODER_ATOL,
    FAMILIES,
    assert_decodes_equal,
    check_fused_step,
    check_resident_kernel,
    family_batch,
    jax_decode,
    jax_encoder_forward,
    make_family,
    port_decode,
    region_boxes,
    set_pallas,
)

POS_ATOL = 1e-6


@pytest.fixture(scope="module")
def family():
    return make_family("dlct")

def _on_grid_lines(seed: int = 0) -> np.ndarray:
    """(2, 12, 4) boxes: random ones, then corners exactly on the f32 grid
    lines k / 7 and one f32 ulp either side of them, then values that
    bf16 rounds onto or across a grid line."""
    rng = np.random.default_rng(seed)
    boxes = region_boxes(rng, 2, 12)
    lines = np.arange(7, dtype=np.float32) / np.float32(7)
    boxes[:, 4:6, 0] = lines[3]
    boxes[:, 4:6, 1] = lines[5]
    boxes[:, 6, 0] = np.nextafter(lines[2], np.float32(0))
    boxes[:, 7, 2] = np.nextafter(lines[4], np.float32(1))
    boxes[:, 8, 3] = lines[6]
    boxes[:, 9:, :] = lines[[1, 2, 4, 6]] + np.float32(2e-3)  # bf16 moves these
    return boxes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_masks_match_jax(dtype):
    """``get_combine_masks`` equal to JAX's, and at bf16 the boxes decide by
    their rounded values against the f32 grid, on both sides."""
    boxes = _on_grid_lines()
    want = np.asarray(jax_combine_masks(jnp.asarray(boxes, dtype=jnp.dtype(dtype)), 7))
    got = get_combine_masks(torch.from_numpy(boxes).to(getattr(torch, dtype)), 7)
    assert got.shape == want.shape == (2, 1, 12, 49) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    if dtype == "bfloat16":  # the rounding moved some cell, as it does in JAX
        f32 = get_combine_masks(torch.from_numpy(boxes), 7)
        assert not torch.equal(f32, got)
    np.testing.assert_array_equal(get_grids_position(3, 49, (7, 7)),
                                  jax_grids_position(3, 49, (7, 7)))


def test_normalized_positions_match_jax():
    """The positions with and without a mask, normalized (DLCT's) and at
    another scale, against JAX's."""
    x = np.zeros((2, 9, 16), np.float32)
    mask = np.zeros((2, 9), bool)
    mask[1, 6:] = True
    for kwargs in ({}, {"normalize": True}, {"normalize": True, "scale": 3.0}):
        for m in (None, mask):
            want = jax_positions(jnp.asarray(x), 16, mask=None if m is None else jnp.asarray(m),
                                 **kwargs)
            got = sinusoid_positional_embedding(
                torch.from_numpy(x), 16, mask=None if m is None else torch.from_numpy(m),
                **kwargs)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=POS_ATOL, rtol=0)


@pytest.mark.parametrize("grid_rows", [49, 56], ids=["grid_49", "padded_56"])
def test_embedding_masks_match_jax(family, grid_rows):
    """The dual embedding's four masks (both padding masks, region2all,
    grid2all) equal JAX's, the 56-row grid's padding rows masked in the
    visibility; its two projections within ENCODER_ATOL."""
    batch = family_batch("dlct", 3, seed=9, grid_rows=grid_rows)
    want = family.jax_model.apply(
        family.jax_params, *(jnp.asarray(batch[k]) for k in
                             ("region_features", "region_boxes", "grid_features", "grid_boxes")),
        method=lambda m, *a: m.vision_embedding(*a))
    with torch.no_grad():
        got = family.port_model.vision_embedding(
            *(torch.from_numpy(batch[k]) for k in
              ("region_features", "region_boxes", "grid_features", "grid_boxes")))
    (wr, wrm), (wg, wgm), (wr2a, wg2a) = want
    (gr, grm), (gg, ggm), (gr2a, gg2a) = got
    for g, w in ((grm, wrm), (ggm, wgm), (gr2a, wr2a), (gg2a, wg2a)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert gr2a.shape == (3, 1, 6, 6 + grid_rows) and gg2a.shape == (3, 1, grid_rows, 6 + grid_rows)
    assert gr2a[..., 6 + 49:].all() and gg2a[:, :, 49:, :6].all()
    for g, w in ((gr, wr), (gg, wg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ENCODER_ATOL, rtol=0)


def test_resident_kernel_matches_jax(family, monkeypatch):
    check_resident_kernel(family, monkeypatch)


def test_fused_step_matches_jax(family, monkeypatch):
    check_fused_step(family, monkeypatch)


def test_bf16_decode_runs_with_boxes_rounded(family, monkeypatch):
    """At bf16 the boxes are cast with the features before the masks are
    built (the JAX beam search casts every floating input), the stream is
    f32 after the positions are added, and the decode gives valid ids."""
    batch = family_batch("dlct", 2, seed=11)
    model = family.port_model
    seen = {}
    real = type(model.vision_embedding).forward

    def spy(self, region_features, region_boxes, *rest):
        seen["dtype"] = region_boxes.dtype
        return real(self, region_features, region_boxes, *rest)
    monkeypatch.setattr(type(model.vision_embedding), "forward", spy)
    out, lp = port_decode(family, batch, compute_dtype=torch.bfloat16)
    assert seen["dtype"] == torch.bfloat16
    assert out.shape == (2, 3, family.vocab.max_caption_length)
    assert ((out >= 0) & (out < len(family.vocab))).all() and torch.isfinite(lp).all()


def test_bucket_padded_grid_matches_jax(family, monkeypatch):
    """The grid stream as the loader pads it (49 -> 56 rows, zero features
    and boxes): the encoder within ENCODER_ATOL with the masks equal, and
    the resident beam decode's tokens equal, log-probs within 1e-4."""
    set_pallas(monkeypatch, False)
    batch = family_batch("dlct", 3, seed=10, grid_rows=56)
    memory, mask = jax_encoder_forward(family, family.jax_params,
                                       {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, got_mask = family.port_model.encoder_forward(
            {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (3, 6 + 56, 16)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(memory), rtol=0,
                               atol=FAMILIES["dlct"]["encoder_atol"])
    assert_decodes_equal(port_decode(family, batch), jax_decode(family, batch))


def test_encoder_without_trig_embedding_matches_jax():
    """With TRIGNOMETRIC_EMBEDDING off (the 4-d displacements, d_g 4) the
    encoder, at two levels, holds ENCODER_ATOL: what remains is f32 sums
    in another order."""
    plain = make_family("dlct", trignometric=False, layers=2)
    batch = family_batch("dlct", 3, seed=12)
    memory, _ = jax_encoder_forward(plain, plain.jax_params,
                                    {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, _ = plain.port_model.encoder_forward(
            {k: torch.from_numpy(v) for k, v in batch.items()})
    assert plain.port_model.encoder.fc_gs.weight.shape == (2, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(memory), atol=ENCODER_ATOL, rtol=0)
