"""Shared cases of the family parity tests,
``tests/test_torch_port_families_<family>.py``: the port's four
single-stream region families and the two-stream DLCT against the JAX
package at f32 on the CPU, with the same weights (drawn with numpy in the
JAX layout, carried through ``compat.from_jax``; the augmented memory's
``m_k`` and ``m_v`` included).

Each family file defines a module-scoped ``family`` fixture (``make_family``)
and imports the ``test_*`` functions below, so that pytest collects them
there and ``--dist loadfile`` spreads the families over workers.  The
families, at the test width (``tests/helpers.py``: d_model 16, 2 heads,
d_ff 32), as their configs set them:

 - ``aoa``: ``configs/attention_on_attention.yaml``, AoA in the encoder's
   and in both decoder attentions;
 - ``augmented_memory``: ``MeshedMemoryTransformer`` over ``Encoder`` with
   ``AugmentedMemoryScaledDotProductAttention`` (4 slots) and ``Decoder``;
 - ``meshed_memory``: ``MultilevelEncoder`` with the augmented memory and
   ``MeshedDecoder`` over its 2 levels;
 - ``camo``: ``CrossAttentionMultiLevelEncoder`` (its 3 layers, a
   single-head encoder attention of d_k 8) and ``Decoder``;
 - ``dlct``: ``configs/dlct_fixed.yaml``'s ``DLCTTransformer``:
   ``GeometricDualFeatureEmbedding`` over 13-d regions with boxes and an
   11-d 7 x 7 grid with ``get_grids_position``'s boxes,
   ``DualCollaborativeLevelEncoder`` (one level of its four geometric
   attentions, the yaml's 3 cut for the JAX jit's time) and one ``Decoder``
   layer; its batches carry the four streams (``family_batch``).

Tolerances: the encoders 1e-5 (the same f32 operations, sums in another
order), DLCT's 2e-4 (its box embedding's sin/cos of arguments up to ~690
rad turn one f32 ulp of an argument, 6.1e-5, into as much of the result:
``tests/test_torch_port_ort.py``'s trig-on bar; without the trig
embedding it holds 1e-5, ``tests/test_torch_port_families_dlct.py``);
teacher-forced and step log-probs 2e-4 (the port's parity bar,
``tests/test_torch_port_model.py``), step against teacher-forced 1e-4;
beam decodes tokens equal and log-probs within 1e-4 (the JAX Pallas kernels
in interpret mode, the port's plain versions), but under ``resident_kernel``
the bars of ``check_resident_kernel``; XE loss 1e-5 relative and
every gradient leaf within 1e-4 of its max-abs
(``tests/test_torch_port_training.py``'s bars)."""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import openviic_tpu_torch.models.decoders as port_decoders
from openviic_tpu.builders import build_model as build_jax_model
from openviic_tpu.config import ConfigNode as JaxConfigNode
from openviic_tpu.decoding import beam_search as jax_beam_search
from openviic_tpu.models.base import make_decode_cache as jax_make_decode_cache
from openviic_tpu.models.geometry import get_grids_position
from openviic_tpu.ops.resident_layer_step import resident_layer_step as jax_resident_step
from openviic_tpu.training import steps as jax_steps
from openviic_tpu_torch.builders import build_model as build_port_model
from openviic_tpu_torch.compat.from_jax import load_jax_params
from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.decoding import beam_search
from openviic_tpu_torch.models.base import make_decode_cache
from openviic_tpu_torch.training import steps
from tests.helpers import model_config
from tests.test_torch_port_support import (
    D_FEATURE,
    make_captions,
    make_features,
    make_vocab,
    random_params,
)
from tests.test_torch_port_training import assert_grads_match, port_state

ENCODER_ATOL = 1e-5
ATOL = 2e-4
STEP_TF_ATOL = 1e-4
BEAM_ATOL = 1e-4
RESIDENT_ATOL = 0.05
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
BEAM = 3

MEMORY = "AugmentedMemoryScaledDotProductAttention"
# eos_gain scales the head's <eos> column so that some beams end early and
# the finished-beam (-999) continuation runs: its sign follows where each
# family's final hidden states point
FAMILIES = {
    "aoa": dict(architecture="StandardTransformerUsingRegion", encoder="Encoder",
                decoder="Decoder", enc_attention="ScaledDotProductAttention", layers=2,
                eos_gain=-6.0),
    "augmented_memory": dict(architecture="MeshedMemoryTransformer", encoder="Encoder",
                             decoder="Decoder", enc_attention=MEMORY, layers=2, eos_gain=-6.0),
    "meshed_memory": dict(architecture="MeshedMemoryTransformer", encoder="MultilevelEncoder",
                          decoder="MeshedDecoder", enc_attention=MEMORY, layers=2, eos_gain=6.0),
    "camo": dict(architecture="CamoTransformer", encoder="CrossAttentionMultiLevelEncoder",
                 decoder="Decoder", enc_attention="ScaledDotProductAttention", layers=3,
                 eos_gain=6.0),
    "dlct": dict(architecture="DLCTTransformer", encoder="DualCollaborativeLevelEncoder",
                 decoder="Decoder", enc_attention="AugmentedGeometryScaledDotProductAttention",
                 layers=1, eos_gain=-6.0, encoder_atol=2e-4, fast_jax=True),
}
D_REGION, D_GRID, GRID = 13, 11, 7  # DLCT's test widths: 13-d regions, an 11-d 7 x 7 grid


def family_config(name: str, dropout: float = 0.1, trignometric: bool = True,
                  layers=None) -> dict:
    """The family's MODEL tree at the test width, every DROPOUT at
    ``dropout`` (``trignometric``: the geometric encoders' embedding;
    ``layers``: other than the family's)."""
    spec = FAMILIES[name]
    config = model_config(architecture=spec["architecture"], encoder=spec["encoder"],
                          decoder=spec["decoder"], enc_attention=spec["enc_attention"],
                          d_feature=D_FEATURE, layers=layers or spec["layers"],
                          trignometric=trignometric).to_dict()
    if name == "aoa":
        for att in (config["ENCODER"]["SELF_ATTENTION"],
                    *config["DECODER"]["ATTENTION"].values()):
            if isinstance(att, dict):
                att["USE_AOA"] = True
    if name == "camo":  # the yaml's single-head encoder attention, d_k kept
        config["ENCODER"]["SELF_ATTENTION"]["HEAD"] = 1
    if name == "dlct":  # the yaml's dual embedding, encoder heads and cross attentions
        config["VISION_EMBEDDING"] = {"ARCHITECTURE": "GeometricDualFeatureEmbedding",
                                      "D_REGION_FEATURE": D_REGION, "D_GRID_FEATURE": D_GRID,
                                      "D_MODEL": config["VISION_EMBEDDING"]["D_MODEL"],
                                      "DROPOUT": 0.1}
        encoder = config["ENCODER"]
        encoder["HEAD"] = encoder["SELF_ATTENTION"]["HEAD"]
        encoder["CROSS_ATTENTION"] = dict(encoder["SELF_ATTENTION"])

    def walk(node):
        if isinstance(node, dict):
            return {k: (dropout if k == "DROPOUT" else walk(v)) for k, v in node.items()}
        return node
    return walk(config)


def region_boxes(rng, bs: int, n: int) -> np.ndarray:
    """(bs, n, 4) normalized boxes (x_min, y_min, x_max, y_max), f32."""
    lo = rng.uniform(0.0, 0.7, size=(bs, n, 2))
    hi = np.minimum(lo + rng.uniform(0.05, 0.5, size=(bs, n, 2)), 1.0)
    return np.concatenate([lo, hi], axis=-1).astype(np.float32)


def family_batch(name: str, bs: int, seed: int = 0, grid_rows: int = GRID * GRID) -> dict:
    """The family's input streams for ``bs`` images as numpy arrays:
    ``make_features``' regions (image 0's last row zero padding), and for
    DLCT their boxes (zero where the row is padding) and a 7 x 7 grid with
    ``get_grids_position``'s boxes, zero rows (features and boxes) past
    49 up to ``grid_rows`` (the loader's bucket padding)."""
    if name != "dlct":
        return {"region_features": make_features(bs, seed=seed)}
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(bs, 6, D_REGION)).astype(np.float32)
    boxes = region_boxes(rng, bs, 6)
    feats[0, -1], boxes[0, -1] = 0.0, 0.0
    n_cells = GRID * GRID
    grid = np.zeros((bs, grid_rows, D_GRID), np.float32)
    grid[:, :n_cells] = rng.normal(size=(bs, n_cells, D_GRID))
    grid_boxes = np.zeros((bs, grid_rows, 4), np.float32)
    grid_boxes[:, :n_cells] = get_grids_position(bs, n_cells, (GRID, GRID))
    return {"region_features": feats, "region_boxes": boxes, "grid_features": grid,
            "grid_boxes": grid_boxes}


def memory_rows(batch: dict) -> int:
    """The rows of the encoder memory a batch gives: its regions, and its
    grid rows where it has a grid."""
    return sum(v.shape[1] for k, v in batch.items() if k.endswith("_features"))


def make_family(name: str, seed: int = 0, **config):
    """The JAX model, its parameters (flat and as a tree) and the port's
    model with the same weights, f32 on the CPU (``config``: of
    ``family_config``)."""
    vocab = make_vocab()
    config = family_config(name, **config)
    jax_model = build_jax_model(JaxConfigNode(config), vocab)
    flat = random_params(jax_model, vocab, seed, FAMILIES[name]["eos_gain"], shapes_only=True,
                         batch=family_batch(name, 2) if name == "dlct" else None)
    port_model = load_jax_params(build_port_model(ConfigNode(config), vocab, device="cpu"), flat)
    return SimpleNamespace(
        name=name, vocab=vocab, config=config, flat=flat, jax_model=jax_model,
        jax_params=traverse_util.unflatten_dict(flat, sep="/"), port_model=port_model)


def set_pallas(monkeypatch, on: bool):
    """``OPENVIIC_PALLAS``: "interpret" runs the JAX Pallas kernels in
    interpret mode, and the port's ``_attend`` through ``fused_attention``
    (its plain version on CPU tensors)."""
    for flag in ("OPENVIIC_PALLAS", "OPENVIIC_FUSED_STEP"):
        monkeypatch.delenv(flag, raising=False)
    if on:
        monkeypatch.setenv("OPENVIIC_PALLAS", "interpret")


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


def _streams(feats) -> dict:
    """A family batch, or a region features array as one."""
    return feats if isinstance(feats, dict) else {"region_features": feats}


def jax_run(family, fn):
    """``fn`` jitted for a family marked ``fast_jax`` (DLCT: op by op its
    JAX encoder compiles for ~12 s at each new shape), else as it is (the
    region families' cases as they were written).  A fresh jit traces
    anew, so it reads the flags of the moment."""
    return jax.jit(fn) if FAMILIES[family.name].get("fast_jax") else fn


def eager_pallas_call(kernel, *, out_shape, scratch_shapes=(), **_):
    """``pl.pallas_call`` for a kernel without a grid: its body runs op by
    op (JAX's eager dispatch) on numpy arrays standing for the refs, the
    outputs and scratch zero-filled first.  Interpret mode compiles the
    JAX resident step's body unrolled over the encoder rows (~2 minutes at
    200 rows); this gives its outputs bit for bit
    (``tests/test_torch_port_two_stream.py``) without the compile."""
    def call(*args):
        outs = [np.zeros(o.shape, o.dtype) for o in out_shape]
        scratch = [np.zeros(x.shape, x.dtype) for x in scratch_shapes]
        kernel(*(np.array(a) for a in args), *outs, *scratch)
        return [jnp.asarray(o) for o in outs]
    return call


def eager_resident_kernel(monkeypatch):
    """The JAX resident step through ``eager_pallas_call`` for the block."""
    import openviic_tpu.ops.resident_layer_step as jax_resident

    monkeypatch.setattr(jax_resident, "pl", SimpleNamespace(
        pallas_call=eager_pallas_call, BlockSpec=jax_resident.pl.BlockSpec))


def jax_encoder_forward(family, params, batch):
    return jax_run(family, functools.partial(family.jax_model.apply,
                                             method=family.jax_model.encoder_forward))(
        params, batch)


def jax_decode(family, feats, **flags):
    return jax_run(family, lambda params, batch: jax_beam_search(
        family.jax_model, params, batch, beam_size=BEAM, out_size=BEAM, **flags))(
        family.jax_params, _jax(_streams(feats)))


def port_decode(family, feats, **flags):
    return beam_search(family.port_model, _torch(_streams(feats)),
                       beam_size=BEAM, out_size=BEAM, **flags)


def assert_decodes_equal(got, want, vocab=None):
    (got_o, got_l), (want_o, want_l) = got, want
    want_o = np.asarray(want_o).reshape(got_o.shape)
    np.testing.assert_array_equal(got_o.numpy(), want_o)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l).reshape(got_l.shape),
                               atol=BEAM_ATOL, rtol=0)
    if vocab is not None:  # some beam finished early: the -999 continuation ran
        assert (want_o[..., :-1] == vocab.eos_idx).any()


@pytest.mark.parametrize("pallas", [False, True], ids=["eager", "pallas"])
def test_encoder_matches_jax(family, monkeypatch, pallas):
    set_pallas(monkeypatch, pallas)
    batch = family_batch(family.name, 3, seed=1)
    memory, mask = jax_encoder_forward(family, family.jax_params, _jax(batch))
    with torch.no_grad():
        got, got_mask = family.port_model.encoder_forward(_torch(batch))
    levels = (2,) if family.name == "meshed_memory" else ()
    assert got.shape == np.shape(memory) == (3,) + levels + (memory_rows(batch), 16)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(memory), rtol=0,
                               atol=FAMILIES[family.name].get("encoder_atol", ENCODER_ATOL))


def test_teacher_forced_log_probs_match_jax(family, monkeypatch):
    set_pallas(monkeypatch, False)
    vocab = family.vocab
    batch = dict(family_batch(family.name, 3, seed=2),
                 caption_tokens=make_captions(vocab, 3, seed=2))
    want = np.asarray(jax.jit(family.jax_model.apply)(family.jax_params, _jax(batch)))
    with torch.no_grad():
        got = family.port_model(_torch(batch)).numpy()
    keep = batch["caption_tokens"] != vocab.padding_idx
    assert got.shape == want.shape == (3, vocab.max_caption_length, len(vocab))
    np.testing.assert_allclose(got[keep], want[keep], atol=ATOL, rtol=0)


def test_step_decode_matches_teacher_forced_and_jax(family):
    """Step t of the cached decode (non-resident) equals the teacher-forced
    log-probs at t in the port, and the JAX ``decode_step``."""
    vocab, jax_model, jax_params, model = (family.vocab, family.jax_model, family.jax_params,
                                           family.port_model)
    feats = family_batch(family.name, 2, seed=3)
    tokens = make_captions(vocab, 2, n_words=4, seed=3)
    memory, memory_mask = jax_encoder_forward(family, jax_params, _jax(feats))
    jcache = jax_make_decode_cache(jax_model.config.DECODER, vocab, 2)
    jcache = jax_model.apply(jax_params, jcache, memory, method=jax_model.prepare_cache)
    jax_step = jax.jit(functools.partial(jax_model.apply, method=jax_model.decode_step))
    with torch.no_grad():
        tbatch = _torch(feats)
        tf = model(dict(tbatch, caption_tokens=torch.from_numpy(tokens).long())).numpy()
        tmem, tmask = model.encoder_forward(tbatch)
        cache = model.prepare_cache(make_decode_cache(model.config.DECODER, vocab, 2), tmem)
        for t in range(6):  # bos, 4 words, then a pad input
            step, cache = model.decode_step(t, torch.from_numpy(tokens[:, t : t + 1]).long(),
                                            cache, tmask)
            jstep, jcache = jax_step(jax_params, t, jnp.asarray(tokens[:, t : t + 1]), jcache,
                                     memory_mask)
            np.testing.assert_allclose(step.numpy(), np.asarray(jstep), atol=ATOL, rtol=0,
                                       err_msg=f"step {t} vs JAX")
            if t < 5:
                np.testing.assert_allclose(step.numpy(), tf[:, t], atol=STEP_TF_ATOL, rtol=0,
                                           err_msg=f"step {t} vs teacher-forced")


BEAM_PATHS = {  # name: (OPENVIIC_PALLAS, beam_search flags of both packages)
    "resident": (False, dict(beam_resident=True)),
    "non_resident": (False, dict(beam_resident=False)),
    # the tuned path: both decode kernels, the encoder through fused_attention
    "kernels_and_pallas": (True, dict(head_kernel=True, attn_kernel=True)),
    # every attention, the decoder's included, through fused_attention
    "pallas_non_resident": (True, dict(beam_resident=False)),
}


@pytest.mark.parametrize("path", list(BEAM_PATHS))
def test_beam_decode_matches_jax(family, monkeypatch, path):
    pallas, flags = BEAM_PATHS[path]
    set_pallas(monkeypatch, pallas)
    feats = family_batch(family.name, 3, seed=4)
    assert_decodes_equal(port_decode(family, feats, **flags), jax_decode(family, feats, **flags),
                         family.vocab)


def _xe_batch(name, vocab, bs: int = 4, seed: int = 5):
    """Teacher-forcing batch of ragged captions (<bos> words <eos>, then
    <pad>) over the family's streams with zero-padded regions."""
    rng = np.random.default_rng(seed)
    L = vocab.max_caption_length
    tokens = np.full((bs, L), vocab.padding_idx, np.int32)
    target = tokens.copy()
    for i in range(bs):
        n = 2 + 2 * i
        enc = np.concatenate([[vocab.bos_idx], rng.integers(4, len(vocab), size=n),
                              [vocab.eos_idx]])
        tokens[i, : n + 1], target[i, : n + 1] = enc[:-1], enc[1:]
    return dict(family_batch(name, bs, seed=seed), caption_tokens=tokens,
                shifted_right_caption_tokens=target)


def test_xe_loss_and_gradients_match_jax(family):
    """One f32 XE step at dropout 0: the loss, and every gradient leaf
    (the memory slots among them) against ``jax.grad`` of the same loss."""
    config = family_config(family.name, dropout=0.0)
    jax_model = build_jax_model(JaxConfigNode(config), family.vocab)
    batch = _xe_batch(family.name, family.vocab)

    def loss_fn(params, b):
        logits = jax_model.apply(params, b, raw_logits=True)
        return jax_steps.fused_nll(logits, b["shifted_right_caption_tokens"],
                                   family.vocab.padding_idx)

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(family.jax_params, _jax(batch))
    want_loss = float(want_loss)
    want = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(grads, sep="/").items()}
    model = load_jax_params(build_port_model(ConfigNode(config), family.vocab, device="cpu"),
                            family.flat)
    _, loss = steps.make_xe_step(model)(port_state(model, d_model=16), _torch(batch))
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    errors = assert_grads_match(model, want, GRAD_TOL, family.flat)
    slots = [k for k in errors if k.endswith(("/m_k", "/m_v"))]
    assert bool(slots) == (family.name in ("augmented_memory", "meshed_memory"))


def test_pipeline_and_scst_step_take_the_family(family):
    """Serving and the SCST step are config-driven: ``CaptioningPipeline``
    captions the family as ``beam_search`` decodes its padded batch, and one
    SCST step (dropout 0) on the family's beams gives the loss of its
    formula over ``scst_log_probs`` and a finite gradient at every
    parameter (the memory slots' nonzero)."""
    from openviic_tpu_torch.serving import CaptioningPipeline
    from openviic_tpu_torch.training import optim

    vocab = family.vocab
    streams = family_batch(family.name, 3, seed=8)
    images = [{k: v[i] for k, v in streams.items()} for i in range(3)]
    pipe = CaptioningPipeline.from_state_dict(
        ConfigNode({"MODEL": family.config, "TRAINING": {"EVALUATING_BEAM_SIZE": BEAM}}), vocab,
        state_dict=family.port_model.state_dict(), batch_size=4, use_bf16=False, device="cpu")
    _, ids = pipe.caption_features(images, return_ids=True)
    want, _ = beam_search(family.port_model, pipe._batch(images), beam_size=BEAM)
    np.testing.assert_array_equal(ids, want.numpy()[:3])

    model = load_jax_params(build_port_model(ConfigNode(family_config(family.name, dropout=0.0)),
                                             vocab, device="cpu"), family.flat)
    batch = _torch(streams)
    sampled, _ = beam_search(model, batch, beam_size=BEAM, out_size=BEAM)
    sampled = sampled.reshape(3 * BEAM, -1)
    reward = torch.rand((3, BEAM), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # every stream repeated to bs x beam rows
        rows = {k: v.repeat_interleave(BEAM, dim=0) for k, v in batch.items()}
        lp = steps.scst_log_probs(model, rows, sampled).reshape(3, BEAM, -1)
        want_loss = (-lp.mean(-1) * (reward - reward.mean(-1, keepdim=True))).mean()
    state = steps.init_xe_state(model, optim.make_rl_optimizer(optim.mask_frozen(model), 5e-6))
    _, loss = steps.make_scst_grad_step(model, BEAM)(state, batch, sampled, reward)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is not None and torch.isfinite(g).all() for g in grads.values())
    slots = [g for n, g in grads.items() if n.endswith(("m_k", "m_v"))]
    assert all(g.abs().max() > 0 for g in slots)
    assert bool(slots) == (family.name in ("augmented_memory", "meshed_memory"))


def count_layer_kernels(monkeypatch, capture: int = 0):
    """Calls of the whole-layer kernels' wrappers from the port's decoder
    layers (on the CPU they run their plain versions, uncounted); the
    arguments of the first ``capture`` calls of each are kept."""
    calls = {"resident_layer_step": [], "fused_layer_step": []}
    for name, seen in calls.items():
        real = getattr(port_decoders, name)

        def wrapper(*args, _seen=seen, _real=real, **kwargs):
            kept = len(_seen) < capture
            _seen.append((tuple(a.clone() if kept and isinstance(a, torch.Tensor) else a
                                for a in args), kwargs) if kept else None)
            return _real(*args, **kwargs)
        monkeypatch.setattr(port_decoders, name, wrapper)
    return calls


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    _, exponent = np.frexp(np.maximum(np.abs(x), 1.0))
    return np.ldexp(1.0, exponent - 8)


def check_resident_call(args, kwargs):
    """One ``resident_layer_step`` call, its captured arguments through the
    port's wrapper (the plain version on CPU tensors) against the JAX
    kernel on the same inputs: k_new and v_new within 1e-5, y within 2 bf16
    ulps of max(|y|, 1) (see ``check_resident_kernel``)."""
    y, k_new, v_new = port_decoders.resident_layer_step(*args, **kwargs)
    jargs = [jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a for a in args[:9]]
    weights = {k: jnp.asarray(v.numpy()) for k, v in args[10].items()}
    wy, wk, wv = jax_resident_step(*jargs, jnp.asarray(args[9]), weights, **kwargs)
    wy = np.asarray(wy).reshape(y.shape)
    np.testing.assert_allclose(k_new.numpy(), np.asarray(wk), atol=ENCODER_ATOL, rtol=0)
    np.testing.assert_allclose(v_new.numpy(), np.asarray(wv), atol=ENCODER_ATOL, rtol=0)
    assert (np.abs(y.numpy() - wy) <= 2 * _bf16_ulp(wy)).all(), np.abs(y.numpy() - wy).max()


def check_resident_kernel(family, monkeypatch):
    """``resident_kernel`` on a family whose decoder the kernel runs: the
    layer calls on their inputs, captured from the port's decode, against
    the JAX Pallas kernel (interpret mode): k_new and v_new within 1e-5
    (f32 sums of the same bf16 products, at an f32 model), y within 2 bf16
    ulps of max(|y|, 1) (``tests/test_torch_port_decode_kernels.py``'s bar:
    both round the same intermediates through bf16, and f32 sums in
    another order can flip one such rounding); and the best beam's tokens
    equal JAX's, its word log-probs within RESIDENT_ATOL (the order by which
    the kernel's bf16 roundings move a word log-prob off the f32 path; the
    two packages' kernels sit far closer to each other).  The lower beams
    are not compared: such flips swap beams that tie within a rounding
    (the augmented-memory family's third beam of one image, where JAX's
    own kernel path departs from its f32 path too)."""
    set_pallas(monkeypatch, False)
    calls = count_layer_kernels(monkeypatch, capture=2)
    feats = family_batch(family.name, 3, seed=6)
    got = beam_search(family.port_model, _torch(feats), beam_size=BEAM, resident_kernel=True)
    want = jax_run(family, lambda params, batch: jax_beam_search(
        family.jax_model, params, batch, beam_size=BEAM, resident_kernel=True))(
        family.jax_params, _jax(feats))
    n_layers = len(family.port_model.decoder.layers)
    assert len(calls["resident_layer_step"]) == n_layers * family.vocab.max_caption_length
    assert not calls["fused_layer_step"]
    if FAMILIES[family.name].get("fast_jax"):  # the per-call kernels op by op
        eager_resident_kernel(monkeypatch)
    for args, kwargs in calls["resident_layer_step"][:2]:  # the first two calls
        check_resident_call(args, kwargs)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=RESIDENT_ATOL, rtol=0)


def assert_best_beams_match(tokens, lp, want_tokens, want_lp, jax_f32_tokens):
    """Best beams (images, max_len) decoded under ``resident_kernel``
    against JAX's under the flag, with ``check_resident_kernel``'s bar: the
    caption equal, its word log-probs within RESIDENT_ATOL.  Where JAX's
    kernel path itself leaves the caption of its f32 path
    (``jax_f32_tokens``), the two tie within the kernel's bf16 roundings:
    the port's caption is then one of the two, its total log-prob within
    RESIDENT_ATOL of JAX's."""
    tokens, lp = np.asarray(tokens), np.asarray(lp)
    for i in range(tokens.shape[0]):
        got, want = tokens[i], want_tokens[i]
        if np.array_equal(want, jax_f32_tokens[i]) or np.array_equal(got, want):
            np.testing.assert_array_equal(got, want, err_msg=f"image {i}")
            np.testing.assert_allclose(lp[i], want_lp[i], atol=RESIDENT_ATOL, rtol=0,
                                       err_msg=f"image {i}")
        else:
            np.testing.assert_array_equal(got, jax_f32_tokens[i], err_msg=f"image {i}")
            assert abs(float(lp[i].sum()) - float(want_lp[i].sum())) <= RESIDENT_ATOL, i


def check_fused_step(family, monkeypatch):
    """``OPENVIIC_FUSED_STEP=1`` on the non-resident path: every layer step
    through ``fused_layer_step`` (f32 throughout at an f32 model), tokens
    equal to JAX's and log-probs within BEAM_ATOL."""
    set_pallas(monkeypatch, False)
    monkeypatch.setenv("OPENVIIC_FUSED_STEP", "1")
    calls = count_layer_kernels(monkeypatch)
    feats = family_batch(family.name, 3, seed=6)  # 9 rows: the JAX kernel takes < 16
    assert_decodes_equal(port_decode(family, feats, beam_resident=False),
                         jax_decode(family, feats, beam_resident=False))
    assert len(calls["fused_layer_step"]) > 0 and not calls["resident_layer_step"]
