"""The port's Object Relation Transformer (``ObjectRelationTransformer``:
``GeometricEncoder``, ``AugmentedGeometryScaledDotProductAttention``,
``models/geometry.py``) and its geometry kernel
(``ops/geo_attention.py``) against the JAX package at f32 on the CPU, with
the same weights carried through ``compat.from_jax``.

On the CPU the port's wrapper runs its plain version; the CUDA kernel is
held against that plain version on the card by ``chip_smoke.py``.  The JAX
Pallas kernels run in interpret mode, as the JAX package's own tests run
them.

Tolerances:
 - the box embedding: 1e-4 (the same f32 operations, but sin/cos of
   arguments up to ~700 rad turn one f32 ulp of the argument, 6.1e-5, into
   as much of the result);
 - the geometry attention: 1e-5; the encoder without the fused kernel:
   1e-5 with the trig embedding off, 2e-4 with it on (that embedding);
 - the geometry kernel's plain version against JAX ``geo_fused_attention``:
   within 1 bf16 ulp of max(|out|, 1) on 99% of the elements and 1e-2
   everywhere (both round q/k/v and the softmax weights to bf16 at the same
   points; f32 sums in other orders can flip one such rounding);
 - the encoder with the fused kernel: 1e-2 (its bf16 roundings of q, k, v
   and the softmax weights are the same on both sides, but f32 sums in
   other orders flip a few of them, each moving an output by up to a few
   1e-3); the forward with it: 2e-4;
 - forwards without it: 2e-4, the port's parity bar; decodes: tokens equal,
   log-probs within 1e-4;
 - bf16 boxes at bf16: the bounds stated beside
   ``test_bf16_box_gap_belongs_to_the_reference``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from openviic_tpu.builders import build_model as build_jax_model
from openviic_tpu.config import ConfigNode as JaxConfigNode
from openviic_tpu.decoding import beam_search as jax_beam_search
from openviic_tpu.models.attention import AugmentedGeometryScaledDotProductAttention as JaxGeoSDPA
from openviic_tpu.models.geometry import box_relational_embedding as jax_box_embedding
from openviic_tpu.ops.geo_attention import geo_fused_attention as jax_geo_fused_attention
from openviic_tpu_torch.builders import build_model as build_port_model
from openviic_tpu_torch.compat.from_jax import load_jax_params, state_dict_from_jax, torch_name
from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.decoding import beam_search
from openviic_tpu_torch.models.attention import AugmentedGeometryScaledDotProductAttention
from openviic_tpu_torch.models.geometry import box_relational_embedding
from openviic_tpu_torch.ops.geo_attention import (
    geo_fused_attention,
    geo_fused_attention_reference,
    geo_fused_enabled,
)
from openviic_tpu_torch.serving import CaptioningPipeline
from tests.helpers import attention_config, model_config
from tests.test_torch_port_support import D_FEATURE, make_captions, make_features, make_vocab

FLAGS = ("OPENVIIC_PALLAS", "OPENVIIC_GEO_FUSED")


def pixel_boxes(bs: int, n: int, seed: int, pad_last: bool = True) -> np.ndarray:
    """(bs, n, 4) boxes in pixels of a 640 x 480 image; image 0's last box is
    zero, as the pipeline pads it (its feature row is zero too)."""
    rng = np.random.default_rng(seed)
    x0, y0 = rng.uniform(0, 560, (bs, n)), rng.uniform(0, 400, (bs, n))
    w, h = rng.uniform(4, 80, (bs, n)), rng.uniform(4, 80, (bs, n))
    boxes = np.stack([x0, y0, x0 + w, y0 + h], axis=-1).astype(np.float32)
    if pad_last:
        boxes[0, -1] = 0.0
    return boxes


def ort_config(trig: bool):
    return model_config(architecture="ObjectRelationTransformer", encoder="GeometricEncoder",
                        enc_attention="AugmentedGeometryScaledDotProductAttention",
                        d_feature=D_FEATURE, trignometric=trig)


def make_ort_pair(vocab, trig: bool, seed: int = 0):
    """(jax_model, jax_params, port_model) of the ORT at the test width, same
    weights drawn with numpy in the JAX layout; the port model f32 on the
    CPU."""
    config = ort_config(trig)
    jax_model = build_jax_model(config, vocab)
    batch = {"region_features": make_features(2), "caption_tokens": make_captions(vocab, 2),
             "region_boxes": pixel_boxes(2, 6, seed=0)}
    with pytest.MonkeyPatch.context() as mp:  # Flax init cannot take the fused branch
        mp.delenv("OPENVIIC_GEO_FUSED", raising=False)
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
    port_model = build_port_model(ConfigNode(config.to_dict()), vocab, device="cpu")
    load_jax_params(port_model, flat)
    return jax_model, traverse_util.unflatten_dict(flat, sep="/"), port_model, flat


@pytest.fixture(scope="module")
def vocab():
    return make_vocab()


@pytest.fixture(scope="module", params=[False, True], ids=["trig_off", "trig_on"])
def ort(request, vocab):
    return (request.param,) + make_ort_pair(vocab, request.param)


def _set_flag(monkeypatch, flag):
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)
    if flag:
        monkeypatch.setenv(flag, "interpret" if flag == "OPENVIIC_PALLAS" else "1")


@pytest.mark.parametrize("trig", [False, True], ids=["trig_off", "trig_on"])
def test_box_relational_embedding_matches_jax(trig):
    boxes = pixel_boxes(3, 7, seed=1)
    want = np.asarray(jax_box_embedding(jnp.asarray(boxes), dim_g=64,
                                        trignometric_embedding=trig))
    got = box_relational_embedding(torch.from_numpy(boxes), dim_g=64,
                                   trignometric_embedding=trig).numpy()
    assert got.shape == want.shape == ((3, 7, 7, 64) if trig else (3, 7, 7, 4))
    np.testing.assert_allclose(got, want, atol=1e-4 if trig else 1e-5, rtol=0)


def test_geometry_attention_matches_jax():
    """The bias branch: log(clamp(g, 1e-6)) of the geometry weights through
    ``_attend``, K and V both projected from ``keys``."""
    cfg = attention_config("AugmentedGeometryScaledDotProductAttention")
    rng = np.random.default_rng(2)
    bs, n, h = 2, 5, cfg["HEAD"]
    x = rng.normal(size=(bs, n, cfg["D_MODEL"])).astype(np.float32)
    values = rng.normal(size=x.shape).astype(np.float32)
    weights = np.maximum(rng.normal(size=(bs, h, n, n)), 0).astype(np.float32)
    mask = np.zeros((bs, 1, 1, n), bool)
    mask[1, ..., -1] = True
    jax_att = JaxGeoSDPA(JaxConfigNode(cfg))
    params = jax_att.init(jax.random.PRNGKey(0), x, x, x, jnp.asarray(weights))
    want = jax_att.apply(params, jnp.asarray(x), jnp.asarray(x), jnp.asarray(values),
                         jnp.asarray(weights), attention_mask=jnp.asarray(mask))
    att = AugmentedGeometryScaledDotProductAttention(ConfigNode(cfg))
    att.load_state_dict(state_dict_from_jax(
        {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}, att))
    with torch.no_grad():
        got = att(torch.from_numpy(x), torch.from_numpy(x), torch.from_numpy(values),
                  attention_mask=torch.from_numpy(mask),
                  relative_geometry_weights=torch.from_numpy(weights))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _geo_case(bs=2, n=10, h=4, dk=8, dg=64, seed=0):
    """``tests/test_geo_attention.py::_random_case``, boxes in pixels."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(bs, n, h, dk)).astype(np.float32) for _ in range(3))
    boxes = pixel_boxes(bs, n, seed, pad_last=False)
    wg = (rng.normal(size=(dg, h)) * 0.2).astype(np.float32)
    bg = (rng.normal(size=(h,)) * 0.1).astype(np.float32)
    pad = np.zeros((bs, 1, 1, n), bool)
    pad[..., -2:] = True
    return q, k, v, boxes, wg, bg, pad


@pytest.mark.parametrize("seed", [0, 1])
def test_geo_plain_matches_jax_kernel(seed):
    case = _geo_case(seed=seed)
    scale = 1 / np.sqrt(case[0].shape[-1])
    want = np.asarray(jax_geo_fused_attention(*(jnp.asarray(a) for a in case), sm_scale=scale))
    launches = geo_fused_attention.launches
    got = geo_fused_attention(*(torch.from_numpy(a) for a in case), sm_scale=scale)
    assert geo_fused_attention.launches == launches  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = np.abs(got.numpy() - want)
    _, exponent = np.frexp(np.maximum(np.abs(want), 1.0))
    assert (err <= np.ldexp(1.0, exponent - 8)).mean() >= 0.99
    assert err.max() <= 1e-2, err.max()


def test_geo_plain_keeps_bf16_and_rounds_like_the_kernel():
    q, k, v, boxes, wg, bg, pad = (torch.from_numpy(a) for a in _geo_case(seed=3))
    out = geo_fused_attention_reference(q.bfloat16(), k.bfloat16(), v.bfloat16(), boxes, wg, bg,
                                        pad, sm_scale=0.35)
    assert out.dtype == torch.bfloat16
    f32 = geo_fused_attention_reference(q, k, v, boxes, wg, bg, pad, sm_scale=0.35)
    torch.testing.assert_close(out.float(), f32, atol=2e-2, rtol=0)  # the output's rounding


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", ["cpu_and_other_device", "shape", "dim_g", "dtype", "heads",
                                  "shared_memory", "not_cuda"])
def test_geo_wrapper_rejects_what_the_kernel_does_not_take(case):
    """Every check but the device one is reached with meta tensors."""
    bs, n, h, dk = 2, 10, 4, 8
    args = [_meta(bs, n, h, dk), _meta(bs, n, h, dk), _meta(bs, n, h, dk),
            _meta(bs, n, 4, dtype=torch.float32), _meta(64, h, dtype=torch.float32),
            _meta(h, dtype=torch.float32), _meta(bs, 1, 1, n, dtype=torch.bool)]
    error, match = ValueError, "cuda"
    if case == "cpu_and_other_device":
        args[0] = torch.zeros(args[0].shape, dtype=args[0].dtype)
    elif case == "shape":
        args[3], match = _meta(bs, n, 5, dtype=torch.float32), "inconsistent shapes"
    elif case == "dim_g":
        args[4], match = _meta(12, h, dtype=torch.float32), "inconsistent shapes"
    elif case == "dtype":
        args[2], error, match = _meta(bs, n, h, dk, dtype=torch.float32), TypeError, "one dtype"
    elif case == "heads":
        big = [_meta(bs, n, 17, dk) for _ in range(3)]
        args[:3] = big
        args[4], args[5] = _meta(64, 17, dtype=torch.float32), _meta(17, dtype=torch.float32)
        match = "h <= 16"
    elif case == "shared_memory":
        n = 2000
        args = [_meta(1, n, h, dk), _meta(1, n, h, dk), _meta(1, n, h, dk),
                _meta(1, n, 4, dtype=torch.float32), args[4], args[5],
                _meta(1, 1, 1, n, dtype=torch.bool)]
        match = "shared memory"
    launches = geo_fused_attention.launches
    with pytest.raises(error, match=match):
        geo_fused_attention(*args, sm_scale=0.3)
    assert geo_fused_attention.launches == launches


def test_geo_flag_is_read_at_call_time(monkeypatch):
    monkeypatch.delenv("OPENVIIC_GEO_FUSED", raising=False)
    assert not geo_fused_enabled()
    for value, on in (("1", True), ("true", True), ("0", False), ("TRUE", False)):
        monkeypatch.setenv("OPENVIIC_GEO_FUSED", value)
        assert geo_fused_enabled() is on


def test_fc_gs_carries_across_under_the_generic_rule(ort):
    trig, _, _, port_model, flat = ort
    assert torch_name("params/encoder/fc_gs/kernel") == ("encoder.fc_gs.weight", True)
    d_g = 8 if trig else 4  # D_MODEL // HEAD with the trig embedding
    np.testing.assert_array_equal(port_model.encoder.fc_gs.weight.detach().numpy(),
                                  flat["params/encoder/fc_gs/kernel"].T)
    assert port_model.encoder.fc_gs.weight.shape == (2, d_g)


def _batch(vocab, bs=3, seed=1):
    return {"region_features": make_features(bs, seed=seed),
            "region_boxes": pixel_boxes(bs, 6, seed=seed),
            "caption_tokens": make_captions(vocab, bs, seed=seed)}


@pytest.mark.parametrize("flag", [None, *FLAGS], ids=["no_flag", "pallas", "geo_fused"])
def test_encoder_matches_jax(ort, vocab, monkeypatch, flag):
    trig, jax_model, jax_params, port_model, _ = ort
    _set_flag(monkeypatch, flag)
    batch = _batch(vocab)
    memory, mask = jax_model.apply(jax_params, {k: jnp.asarray(v) for k, v in batch.items()},
                                   method=jax_model.encoder_forward)
    with torch.no_grad():
        got, got_mask = port_model.encoder_forward(
            {k: torch.from_numpy(v) for k, v in batch.items() if k != "caption_tokens"})
    atol = (1e-2 if flag == "OPENVIIC_GEO_FUSED" else 2e-4) if trig else 1e-5
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(memory), atol=atol, rtol=0)


@pytest.mark.parametrize("flag", [None, *FLAGS], ids=["no_flag", "pallas", "geo_fused"])
def test_forward_matches_jax(ort, vocab, monkeypatch, flag):
    _, jax_model, jax_params, port_model, _ = ort
    _set_flag(monkeypatch, flag)
    batch = _batch(vocab, seed=2)
    want = np.asarray(jax_model.apply(jax_params, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        got = port_model({k: torch.from_numpy(v).long() if k == "caption_tokens"
                          else torch.from_numpy(v) for k, v in batch.items()}).numpy()
    keep = batch["caption_tokens"] != vocab.padding_idx
    np.testing.assert_allclose(got[keep], want[keep], atol=2e-4, rtol=0)


@pytest.mark.parametrize("flag", [None, *FLAGS], ids=["no_flag", "pallas", "geo_fused"])
@pytest.mark.parametrize("beam_resident", [True, False], ids=["resident", "non_resident"])
def test_beam_decode_matches_jax(ort, vocab, monkeypatch, flag, beam_resident):
    _, jax_model, jax_params, port_model, _ = ort
    _set_flag(monkeypatch, flag)
    batch = _batch(vocab, seed=3)
    del batch["caption_tokens"]
    want_o, want_l = jax_beam_search(jax_model, jax_params,
                                     {k: jnp.asarray(v) for k, v in batch.items()},
                                     beam_size=3, out_size=3, beam_resident=beam_resident)
    got_o, got_l = beam_search(port_model, {k: torch.from_numpy(v) for k, v in batch.items()},
                               beam_size=3, out_size=3, beam_resident=beam_resident)
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=1e-4, rtol=0)


def test_pipeline_pads_boxes_and_decodes_like_jax(vocab):
    """``CaptioningPipeline`` pads each image's boxes with zero rows to the
    bucketed region count, as it pads the features, and serves the ORT."""
    jax_model, jax_params, port_model, _ = make_ort_pair(vocab, trig=True, seed=1)
    config = ConfigNode({"MODEL": ort_config(True).to_dict(),
                         "TRAINING": {"EVALUATING_BEAM_SIZE": 3}})
    pipe = CaptioningPipeline(config, vocab, state_dict=port_model.state_dict(), batch_size=4,
                              use_bf16=False, device="cpu")
    rng = np.random.default_rng(4)
    images = []
    for i in range(3):
        n = int(rng.integers(4, 7))
        images.append({"region_features": rng.normal(size=(n, D_FEATURE)).astype(np.float32),
                       "region_boxes": pixel_boxes(1, n, seed=10 + i, pad_last=False)[0]})
    batch = pipe._batch(images)
    assert batch["region_boxes"].shape == (4, 8, 4) and batch["region_boxes"].dtype == torch.float32
    assert (batch["region_boxes"][0, len(images[0]["region_boxes"]):] == 0).all()
    _, ids = pipe.caption_features(images, return_ids=True)
    want, _ = jax_beam_search(jax_model, jax_params,
                              {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
                              beam_size=3, beam_resident=True)
    np.testing.assert_array_equal(ids, np.asarray(want)[:3])


# With the boxes in bf16, as the beam search casts every floating input (the
# JAX package's rule), the eager encoder computes its log displacements in
# bf16: the trig embedding's 100-rad-per-unit frequencies then carry phase
# errors of order 1 rad that the kernel's f32 displacements do not.  Measured
# on this test's model (CPU): the forced log-prob gap between the kernel
# path and the eager path is 1.02 in JAX and 0.97 in the port with bf16
# boxes, 0.014 and 0.013 with f32 boxes, while each path of the port is
# within 0.04 of its JAX twin.  So the gap belongs to the reference.
BOX_GAP_REFERENCE_MIN = 0.5  # JAX's own kernel-vs-eager gap, bf16 boxes
BOX_GAP_F32_MAX = 0.05       # either package's gap, f32 boxes
BOX_GAP_AGREE = 0.1          # |port gap - JAX gap|
BOX_CROSS_MAX = 0.05         # each port path against its JAX twin (bf16 model)


def test_bf16_box_gap_belongs_to_the_reference(vocab, monkeypatch):
    """The ORT trig-on at bf16, teacher-forced on the same captions: the
    per-step log-prob of each forced token through the eager encoder and
    through the geometry kernel (``OPENVIIC_GEO_FUSED``), in both packages,
    with f32 and with bf16 boxes."""
    jax_model, jax_params, port_model, _ = make_ort_pair(vocab, trig=True)
    bs = 4
    feats, boxes = make_features(bs, seed=5), pixel_boxes(bs, 6, seed=5)
    tokens = make_captions(vocab, bs, seed=5)
    targets = tokens[:, 1:]
    keep = targets != vocab.padding_idx
    bf = jnp.bfloat16
    jax_params = jax.tree.map(lambda a: a.astype(bf), jax_params)
    port_model = port_model.to(torch.bfloat16)

    def forced(log_probs):
        log_probs = np.asarray(log_probs, np.float32)[:, :-1]
        return np.take_along_axis(log_probs, targets[..., None], 2)[..., 0][keep]

    gaps = {}
    for box_dtype in ("f32", "bf16"):
        scores = {}
        for flag in (None, "OPENVIIC_GEO_FUSED"):
            _set_flag(monkeypatch, flag)  # JAX reads it when it traces: apply is not jitted
            jax_boxes = jnp.asarray(boxes, bf if box_dtype == "bf16" else jnp.float32)
            want = jax_model.apply(jax_params, {"region_features": jnp.asarray(feats, bf),
                                                "region_boxes": jax_boxes,
                                                "caption_tokens": jnp.asarray(tokens)})
            port_boxes = torch.from_numpy(boxes)
            with torch.no_grad():
                got = port_model({
                    "region_features": torch.from_numpy(feats).bfloat16(),
                    "region_boxes": port_boxes.bfloat16() if box_dtype == "bf16" else port_boxes,
                    "caption_tokens": torch.from_numpy(tokens).long()})
            scores[flag] = forced(want), forced(got.float().numpy())
        (jax_eager, port_eager), (jax_kernel, port_kernel) = scores[None], scores[
            "OPENVIIC_GEO_FUSED"]
        gaps[box_dtype] = (np.abs(jax_kernel - jax_eager).max(),
                           np.abs(port_kernel - port_eager).max())
        cross = max(np.abs(port_eager - jax_eager).max(), np.abs(port_kernel - jax_kernel).max())
        assert cross <= BOX_CROSS_MAX, (box_dtype, cross)
    jax_gap, port_gap = gaps["bf16"]
    assert jax_gap >= BOX_GAP_REFERENCE_MIN, gaps
    assert abs(port_gap - jax_gap) <= BOX_GAP_AGREE, gaps
    assert max(gaps["f32"]) <= BOX_GAP_F32_MAX, gaps
