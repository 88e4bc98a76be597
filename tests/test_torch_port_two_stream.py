"""The two-stream families in the port beyond DLCT's parity cases
(``tests/test_torch_port_families_dlct*.py``), on the CPU:

 - ``UnifiedTransformer`` against the JAX package at f32 with the same
   weights, at the one shape it typechecks at (every stream 4 wide): the
   teacher-forced log-probs within 2e-4 (the port's parity bar) and the
   resident beam decode's tokens equal, log-probs within 1e-4;
 - both whole-layer steps' plain versions at an encoder length M = 200
   against the JAX Pallas kernels, with the bars of
   ``tests/test_torch_port_decode_kernels.py`` (resident at bf16: k_new
   and v_new equal, y within 2 bf16 ulps; fused at f32: within 1e-5): the
   fused kernel in interpret mode; the resident kernel's body run op by op
   on numpy refs (``torch_port_families.eager_pallas_call``, bit-equal to
   interpret mode at M = 6), since interpret mode compiles that body,
   unrolled over the 200 positions, for about two minutes;
 - DLCT served from its four streams: ``caption_directory`` equal to
   ``caption_features``, ``caption_images`` refusing
   ``configs/dlct_fixed.yaml``'s 1024-wide regions beside 2048-wide grids
   with the JAX package's ``ValueError`` and captioning where the two
   widths are equal;
 - ``viTrainer`` on ``configs/dlct_fixed.yaml`` at the test width through
   the switch to SCST, its loader padding the 49-row grid streams to 56."""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from openviic_tpu.builders import build_model as build_jax_model
from openviic_tpu.config import ConfigNode as JaxConfigNode
from openviic_tpu.decoding import beam_search as jax_beam_search
from openviic_tpu.ops.fused_decoder_step import fused_layer_step as jax_fused_step
from openviic_tpu.ops.resident_layer_step import resident_layer_step as jax_resident_step
from openviic_tpu_torch.builders import build_model as build_port_model
from openviic_tpu_torch.builders import build_trainer
from openviic_tpu_torch.compat.from_jax import load_jax_params
from openviic_tpu_torch.config import ConfigNode, get_config
from openviic_tpu_torch.decoding import beam_search
from openviic_tpu_torch.models.geometry import get_grids_position
from openviic_tpu_torch.ops.fused_decoder_step import fused_layer_step_reference
from openviic_tpu_torch.ops.resident_layer_step import resident_layer_step_reference
from openviic_tpu_torch.serving import CaptioningPipeline
from tests.helpers import model_config
from tests.test_torch_port_decode_kernels import ATOL_F32, _bf16_ulp, _to_np, _to_torch, _weights
from tests.test_torch_port_support import make_captions, make_vocab, random_params
from tests.torch_port_families import (
    BEAM,
    assert_decodes_equal,
    eager_resident_kernel,
    family_batch,
    family_config,
)

ROOT = Path(__file__).resolve().parents[1]
ATOL = 2e-4


# ------------------------------------------------------------ UnifiedTransformer
def _unified_batch(bs: int, seed: int) -> dict:
    """Four 4-wide streams: regions (image 0's last row zero padding, its
    box too) with their boxes, a 3 x 3 grid with its cells' boxes."""
    rng = np.random.default_rng(seed)
    regions = rng.normal(size=(bs, 5, 4)).astype(np.float32)
    boxes = rng.uniform(0.0, 1.0, size=(bs, 5, 4)).astype(np.float32)
    regions[0, -1], boxes[0, -1] = 0.0, 0.0
    return {"region_features": regions, "region_boxes": boxes,
            "grid_features": rng.normal(size=(bs, 9, 4)).astype(np.float32),
            "grid_boxes": get_grids_position(bs, 9, (3, 3))}


@pytest.fixture(scope="module")
def unified():
    vocab = make_vocab()
    config = model_config(architecture="UnifiedTransformer", d_feature=4).to_dict()
    jax_model = build_jax_model(JaxConfigNode(config), vocab)
    flat = random_params(jax_model, vocab, 3, eos_gain=-6.0, shapes_only=True,
                         batch=_unified_batch(2, 0))
    port_model = load_jax_params(build_port_model(ConfigNode(config), vocab, device="cpu"), flat)
    return vocab, jax_model, traverse_util.unflatten_dict(flat, sep="/"), port_model


def test_unified_forward_and_beam_match_jax(unified):
    vocab, jax_model, jax_params, port_model = unified
    batch = dict(_unified_batch(3, 1), caption_tokens=make_captions(vocab, 3, seed=1))
    want = np.asarray(jax.jit(jax_model.apply)(jax_params,
                                               {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        got = port_model({k: torch.from_numpy(v).long() if v.dtype.kind == "i"
                          else torch.from_numpy(v) for k, v in batch.items()}).numpy()
    keep = batch["caption_tokens"] != vocab.padding_idx
    assert got.shape == want.shape == (3, vocab.max_caption_length, len(vocab))
    np.testing.assert_allclose(got[keep], want[keep], atol=ATOL, rtol=0)

    streams = _unified_batch(3, 2)
    want = jax.jit(lambda p, b: jax_beam_search(jax_model, p, b, beam_size=BEAM,
                                                out_size=BEAM))(
        jax_params, {k: jnp.asarray(v) for k, v in streams.items()})
    got = beam_search(port_model, {k: torch.from_numpy(v) for k, v in streams.items()},
                      beam_size=BEAM, out_size=BEAM)
    assert_decodes_equal(got, want)
    memory, mask = port_model.encoder_forward({k: torch.from_numpy(v)
                                               for k, v in streams.items()})
    assert memory.shape == (3, 5 + 5 + 9 + 9, 16) and mask[0, 0, 0, [4, 9]].all()


# ------------------------------------------------------------- layer steps at M 200
IMG, BEAM_ROWS, L, M, D, H = 3, 5, 7, 200, 16, 2
N = IMG * BEAM_ROWS


def _long_inputs(seed: int, t: int):
    """A mid-decode step over 200 encoder rows: ancestry with each beam's
    own slot at t, raw per-slot pads, future positions masked, images with
    100-200 live rows, some <pad> input tokens."""
    rng = np.random.default_rng(seed)
    d = D // H
    x = rng.normal(size=(N, D)).astype(np.float32)
    kc, vc = (rng.normal(size=(N, L, H, d)).astype(np.float32) for _ in range(2))
    ck, cv = (rng.normal(size=(IMG, M, H, d)).astype(np.float32) for _ in range(2))
    anc = rng.integers(0, BEAM_ROWS, size=(IMG, BEAM_ROWS, L))
    anc[:, :, t] = np.arange(BEAM_ROWS)[None]
    smask = rng.random((N, L)) < 0.2
    smask[:, t + 1:] = True
    smask[:, 0] = False
    cmask = np.arange(M)[None] >= rng.integers(100, M + 1, size=(IMG, 1))
    is_pad = rng.random((N, 1)) < 0.2
    return x, kc, vc, ck, cv, anc, smask, cmask, is_pad, _weights(rng)


def _jax_resident(inputs, t):
    x, kc, vc, ck, cv, anc, smask, cmask, is_pad, w = inputs
    n, L_, m, bf = x.shape[0], kc.shape[1], ck.shape[1], jnp.bfloat16
    return jax_resident_step(
        jnp.asarray(x, bf)[:, None], jnp.asarray(kc, bf), jnp.asarray(vc, bf),
        jnp.asarray(ck, bf), jnp.asarray(cv, bf), jnp.asarray(anc, jnp.int32),
        jnp.asarray(smask).reshape(n, 1, 1, L_), jnp.asarray(cmask).reshape(-1, 1, 1, m),
        jnp.asarray(is_pad), jnp.asarray(t), {k: jnp.asarray(v, bf) for k, v in w.items()},
        n_heads=H)


def test_eager_pallas_call_is_interpret_mode(monkeypatch):
    """The stand-in gives interpret mode's outputs bit for bit on the
    decode-kernel tests' short memory (M = 6)."""
    from tests.test_torch_port_decode_kernels import _layer_inputs

    inputs = _layer_inputs(0, 4)
    want = _jax_resident(inputs, 4)
    eager_resident_kernel(monkeypatch)
    for g, w in zip(_jax_resident(inputs, 4), want):
        np.testing.assert_array_equal(_to_np(g), _to_np(w))


def test_resident_step_plain_takes_a_long_memory(monkeypatch):
    eager_resident_kernel(monkeypatch)
    t = 4
    inputs = _long_inputs(0, t)
    x, kc, vc, ck, cv, anc, smask, cmask, is_pad, w = inputs
    tb = torch.bfloat16
    want = _jax_resident(inputs, t)
    got = resident_layer_step_reference(
        _to_torch(x, tb)[:, None], _to_torch(kc, tb), _to_torch(vc, tb), _to_torch(ck, tb),
        _to_torch(cv, tb), _to_torch(anc), _to_torch(smask).reshape(N, 1, 1, L),
        _to_torch(cmask).reshape(IMG, 1, 1, M), _to_torch(is_pad), t,
        {k: _to_torch(v, tb) for k, v in w.items()}, H)
    y, k_new, v_new = (_to_np(a) for a in got)
    wy, wk, wv = (_to_np(a) for a in want)
    np.testing.assert_array_equal(k_new, wk.reshape(k_new.shape))
    np.testing.assert_array_equal(v_new, wv.reshape(v_new.shape))
    assert (np.abs(y - wy) <= 2 * _bf16_ulp(wy)).all(), np.abs(y - wy).max()


def test_fused_step_plain_takes_a_long_memory():
    t = 3
    x, kc, vc, ck, cv, _, smask, cmask, _, w = _long_inputs(1, t)
    kc3, vc3 = kc.reshape(N, L, D), vc.reshape(N, L, D)
    ck_rows = np.repeat(ck.reshape(IMG, M, D), BEAM_ROWS, axis=0)
    cv_rows = np.repeat(cv.reshape(IMG, M, D), BEAM_ROWS, axis=0)
    cmask_rows = np.repeat(cmask, BEAM_ROWS, axis=0)
    want_y, want_k, want_v = jax_fused_step(
        jnp.asarray(x), jnp.asarray(kc3), jnp.asarray(vc3), jnp.asarray(ck_rows),
        jnp.asarray(cv_rows), jnp.asarray(smask), jnp.asarray(cmask_rows), jnp.asarray(t),
        {k: jnp.asarray(v) for k, v in w.items()}, n_heads=H, block_rows=N)
    k_cache, v_cache = _to_torch(kc3.copy()), _to_torch(vc3.copy())
    y, _, _ = fused_layer_step_reference(
        _to_torch(x), k_cache, v_cache, _to_torch(ck_rows), _to_torch(cv_rows),
        _to_torch(smask), _to_torch(cmask_rows), t, {k: _to_torch(v) for k, v in w.items()}, H)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=ATOL_F32, rtol=0)
    np.testing.assert_allclose(k_cache.numpy(), np.asarray(want_k), atol=ATOL_F32, rtol=0)
    np.testing.assert_allclose(v_cache.numpy(), np.asarray(want_v), atol=ATOL_F32, rtol=0)


# ------------------------------------------------------------------ DLCT serving
def _dlct_pipeline(config: dict, vocab) -> CaptioningPipeline:
    return CaptioningPipeline.from_state_dict(
        ConfigNode({"MODEL": config, "TRAINING": {"EVALUATING_BEAM_SIZE": BEAM}}), vocab,
        batch_size=4, use_bf16=False, device="cpu", seed=2)


def test_dlct_caption_directory_takes_the_four_streams(tmp_path):
    """Feature files of the four streams (a 49-row grid, which the pipeline
    pads to 56) caption as ``caption_features`` captions them."""
    vocab = make_vocab()
    pipe = _dlct_pipeline(family_config("dlct"), vocab)
    streams = family_batch("dlct", 5, seed=13)
    images = [{k: v[i] for k, v in streams.items()} for i in range(5)]
    for i, image in enumerate(images):
        np.save(tmp_path / f"{i}.npy", image, allow_pickle=True)
    assert pipe._batch(images[:4])["grid_features"].shape == (4, 56, 11)
    want = pipe.caption_features(images)
    got = pipe.caption_directory(str(tmp_path))
    assert got == {str(i): c for i, c in enumerate(want)}


def test_dlct_caption_images_needs_one_feature_width():
    """``caption_images`` pools regions from the grid feature map: the
    yaml's 1024-wide regions beside 2048-wide grids raise the JAX
    package's ``ValueError``; equal widths caption every image, as
    ``caption_features`` does their extracted streams."""
    from openviic_tpu_torch.data.extraction import extract_feature_dict, grid_boxes

    vocab = make_vocab()
    yaml_model = get_config(str(ROOT / "configs" / "dlct_fixed.yaml")).MODEL.to_dict()
    config = family_config("dlct")
    config["VISION_EMBEDDING"] = dict(yaml_model["VISION_EMBEDDING"], D_MODEL=16)
    with pytest.raises(ValueError, match="D_REGION_FEATURE=1024"):
        _dlct_pipeline(config, vocab).caption_images([np.zeros((24, 24, 3), np.uint8)])

    config["VISION_EMBEDDING"].update(D_REGION_FEATURE=11, D_GRID_FEATURE=11)
    pipe = _dlct_pipeline(config, vocab)
    arrays = list(np.random.default_rng(14).integers(0, 256, size=(3, 24, 24, 3), dtype=np.uint8))
    got = pipe.caption_images(arrays, grid=7)
    backbone, cells = pipe.backbone("patch", 7), grid_boxes(7)
    want = pipe.caption_features([extract_feature_dict(a, backbone, cells, cells) for a in arrays])
    assert got == dict(enumerate(want))


# ------------------------------------------------------------------- DLCT trainer
def _dlct_dataset(root: Path) -> Path:
    """Eight images of 3-7 regions (13-d, with boxes) and a 7 x 7 grid of
    11-d features with its cells' boxes; captions in three splits."""
    rng = np.random.default_rng(0)
    captions = ["một người đàn ông đang đi bộ", "hai đứa trẻ chơi bóng đá",
                "một con mèo nằm trên ghế", "người phụ nữ đang nấu ăn"]
    for name, ids in (("train", [0, 1, 2, 3]), ("dev", [4, 5]), ("test", [6, 7])):
        anns = [{"image_id": i, "caption": captions[(i + c) % 4]} for i in ids for c in range(2)]
        with open(root / f"{name}.json", "w") as f:
            json.dump({"images": [{"id": i, "file_name": f"{i}.jpg"} for i in ids],
                       "annotations": anns}, f)
    (root / "features").mkdir()
    for i in range(8):
        n = int(rng.integers(3, 8))
        lo = rng.uniform(0.0, 0.6, size=(n, 2))
        boxes = np.concatenate([lo, lo + rng.uniform(0.1, 0.4, size=(n, 2))], axis=1)
        np.save(root / "features" / f"{i}.npy", {
            "region_features": rng.normal(size=(n, 13)).astype(np.float32),
            "region_boxes": boxes.astype(np.float32),
            "grid_features": rng.normal(size=(49, 11)).astype(np.float32),
            "grid_boxes": get_grids_position(1, 49, (7, 7))[0],
        }, allow_pickle=True)
    return root


def test_dlct_vitrainer_runs_through_the_switch(tmp_path):
    """``configs/dlct_fixed.yaml`` with its MODEL at the test width and its
    data on the tiny dataset: one XE epoch, the switch (PATIENCE 0), one
    SCST epoch; the losses are finite and every batch's grid streams come
    padded to 56 rows."""
    root = _dlct_dataset(tmp_path)
    config = get_config(str(ROOT / "configs" / "dlct_fixed.yaml")).to_dict()
    config["MODEL"] = dict(family_config("dlct"), NAME="dlct_tiny")
    config["DATASET"].update(
        FEATURE_BATCH_SIZE=4, DICT_BATCH_SIZE=4, WORKERS=0,
        JSON_PATH={"TRAIN": str(root / "train.json"), "DEV": str(root / "dev.json"),
                   "TEST": str(root / "test.json")})
    config["DATASET"]["FEATURE_PATH"]["FEATURES"] = str(root / "features")
    config["TRAINING"].update(CHECKPOINT_PATH=str(tmp_path / "saved"), PATIENCE=0,
                              TRAINING_BEAM_SIZE=2, EVALUATING_BEAM_SIZE=2)
    trainer = build_trainer(ConfigNode(config), device="cpu")
    batch = next(iter(trainer.train_dataloader))
    assert batch["grid_features"].shape[1:] == (56, 11)
    assert batch["grid_boxes"].shape[1:] == (56, 4)
    losses = {}
    for name in ("train", "train_scst"):
        real = getattr(trainer, name)

        def record(_real=real, _name=name):
            losses[_name] = _real()
            return losses[_name]
        setattr(trainer, name, record)
    trainer.start(max_epochs=2)
    assert trainer.use_rl and set(losses) == {"train", "train_scst"}
    assert all(np.isfinite(v) for v in losses.values()), losses
    assert os.path.isfile(tmp_path / "saved" / "dlct_tiny" / "last_model.ckpt")
