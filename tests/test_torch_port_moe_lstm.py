"""The Switch MoE feed-forward, ``LSTMTextEmbedding`` and the beam search's
``return_probs`` and ``beam_search_multi`` in the PyTorch port against the
JAX package, f32 on the CPU, with the same weights (drawn with numpy in
the JAX layout, carried through ``compat.from_jax``).

The model is the flagship at the test width (d_model 16, 2 heads, 2 + 2
layers) with every FFN a 4-expert MoE (the encoder's and the decoder's)
and ``LSTMTextEmbedding`` as the decoder's word embedding.  Bars: the MoE
FFN and the LSTM embedding 1e-5, teacher-forced log-probs 2e-4 (the
port's parity bar), beam decodes tokens equal and log-probs within 1e-4,
the kept distributions of ``return_probs`` within 1e-4, XE loss 1e-5
relative and every gradient leaf within 1e-4 of its max-abs
(``tests/test_torch_port_training.py``'s bars).  The JAX decodes are few
(each costs seconds of compile): the fast-select path, and the head and
attention kernels together (both plain versions in the port, the JAX
Pallas kernels in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from openviic_tpu.builders import build_model as build_jax_model
from openviic_tpu.config import ConfigNode as JaxConfigNode
from openviic_tpu.decoding import beam_search as jax_beam_search
from openviic_tpu.decoding.beam_search import beam_search_multi as jax_beam_search_multi
from openviic_tpu.models.ffn import MoEPositionWiseFeedForward as JaxMoE
from openviic_tpu.models.text_embedding import LSTMTextEmbedding as JaxLSTMEmbedding
from openviic_tpu.training import steps as jax_steps
from openviic_tpu_torch.builders import build_model as build_port_model
from openviic_tpu_torch.compat.from_jax import load_jax_params
from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.decoding import beam_search
from openviic_tpu_torch.decoding.beam_search import beam_search_multi
from openviic_tpu_torch.models.decoders import MOE_LAYER_KERNEL
from openviic_tpu_torch.models.ffn import MoEPositionWiseFeedForward
from openviic_tpu_torch.models.text_embedding import FlaxLSTM, LSTMTextEmbedding
from openviic_tpu_torch.training import steps
from tests.helpers import attention_config, model_config
from tests.test_torch_port_support import make_captions, make_features, make_vocab, random_params
from tests.test_torch_port_training import assert_grads_match, port_state

ATOL = 1e-5
TF_ATOL = 2e-4
BEAM_ATOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
BEAM = 3
EXPERTS = 4


def moe_lstm_config(dropout: float = 0.1) -> dict:
    config = model_config().to_dict()
    config["ENCODER"]["SELF_ATTENTION"]["MOE_EXPERTS"] = EXPERTS
    config["DECODER"]["ATTENTION"]["ENC_ATTENTION"]["MOE_EXPERTS"] = EXPERTS
    config["DECODER"]["TEXT_EMBEDDING"]["ARCHITECTURE"] = "LSTMTextEmbedding"

    def walk(node):
        if isinstance(node, dict):
            return {k: (dropout if k == "DROPOUT" else walk(v)) for k, v in node.items()}
        return node
    return walk(config)


def scaled(flat: dict, seed: int = 0) -> dict:
    """``random_params``' leaves with the stacked experts drawn at a Linear's
    scale: kernels 1/sqrt(fan_in), biases 0.1 (their JAX leaves, ``w1`` ...,
    are neither ``kernel`` nor ``bias``)."""
    rng = np.random.default_rng(seed)
    out = dict(flat)
    for key, value in flat.items():
        if key.endswith(("/w1", "/w2")):
            out[key] = (rng.normal(size=value.shape) / np.sqrt(value.shape[1])).astype(np.float32)
        elif key.endswith(("/b1", "/b2")):
            out[key] = (0.1 * rng.normal(size=value.shape)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def pair():
    vocab = make_vocab()
    config = moe_lstm_config()
    jax_model = build_jax_model(JaxConfigNode(config), vocab)
    flat = scaled(random_params(jax_model, vocab, 0, eos_gain=-6.0, shapes_only=True))
    port = load_jax_params(build_port_model(ConfigNode(config), vocab, device="cpu"), flat)
    return dict(vocab=vocab, config=config, jax_model=jax_model, flat=flat, port=port,
                params=traverse_util.unflatten_dict(flat, sep="/"))


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    _, exponent = np.frexp(np.maximum(np.abs(x), 1e-30))
    return np.ldexp(1.0, exponent - 8)


def _module_params(module, *args, seed: int = 0) -> dict:
    """A module's parameters drawn with numpy over ``module.init``'s shapes
    (traced, not run): kernels N(0, 1/fan_in), biases N(0, 0.01), the
    stacked experts as ``scaled`` draws them, the rest N(0, 1)."""
    template = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)
    flat = {}
    for key, leaf in traverse_util.flatten_dict(template, sep="/").items():
        shape = leaf.shape
        if key.endswith("kernel"):
            value = rng.normal(size=shape) / np.sqrt(shape[0])
        elif key.endswith("bias"):
            value = 0.1 * rng.normal(size=shape)
        else:
            value = rng.normal(size=shape)
        flat[key] = value.astype(np.float32)
    return scaled(flat, seed)


@pytest.mark.parametrize("case", ["default_capacity", "overflow", "bf16"])
def test_moe_ffn_matches_jax(case):
    """Routing, the capacity (at 0.5 most tokens overflow and pass through
    the residual unchanged), the Switch aux loss, f32 within 1e-5; at bf16
    parameters and input the dtypes of the JAX layer (router and experts
    f32, the output rounded to bf16 once) within a bf16 ulp."""
    node = attention_config()
    node["MOE_EXPERTS"] = EXPERTS
    if case == "overflow":
        node["MOE_CAPACITY_FACTOR"] = 0.5
    x = np.random.default_rng(1).normal(size=(3, 10, 16)).astype(np.float32)
    jax_layer = JaxMoE(JaxConfigNode(node))
    flat = _module_params(jax_layer, jnp.asarray(x), seed=1)
    layer = load_jax_params(MoEPositionWiseFeedForward(ConfigNode(node)), flat).eval()
    params = traverse_util.unflatten_dict(flat, sep="/")
    if case == "bf16":
        params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
        layer = layer.to(torch.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16 if case == "bf16" else jnp.float32)
    want, sown = jax.jit(lambda p, v: jax_layer.apply(p, v, mutable=["intermediates"]))(
        params, xj)
    with torch.no_grad():
        got = layer(torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
            torch.bfloat16 if case == "bf16" else torch.float32))
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == (torch.bfloat16 if case == "bf16" else torch.float32)
    got = got.float().numpy()
    if case == "bf16":
        assert (np.abs(got - want) <= _bf16_ulp(want)).all(), np.abs(got - want).max()
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    aux = float(sown["intermediates"]["moe_aux_loss"][0])
    assert abs(float(layer.aux_loss) - aux) <= 1e-6
    capacity = layer.capacity(30)
    assert capacity == int(max(1, -(-layer.capacity_factor * 30 // EXPERTS)))
    if case == "overflow":  # the dropped tokens: the residual alone, normalised
        with torch.no_grad():
            alone = layer.layer_norm(torch.from_numpy(x)).numpy()
        passed = np.isclose(got, alone, atol=ATOL).all(axis=-1).reshape(-1)
        assert capacity == 4 and passed.sum() >= 30 - EXPERTS * capacity


def test_lstm_embedding_matches_jax():
    """Embedding, proj, dropout (off), the LSTM over every position
    (padding included) from a zero carry, within 1e-5 at f32."""
    vocab = make_vocab()
    node = moe_lstm_config()["DECODER"]["TEXT_EMBEDDING"]
    tokens = make_captions(vocab, 3, n_words=5, seed=2)
    jax_layer = JaxLSTMEmbedding(JaxConfigNode(node), vocab)
    flat = _module_params(jax_layer, jnp.asarray(tokens))
    layer = load_jax_params(LSTMTextEmbedding(ConfigNode(node), vocab), flat).eval()
    want, (want_pad, want_seq) = jax.jit(jax_layer.apply)(
        traverse_util.unflatten_dict(flat, sep="/"), jnp.asarray(tokens))
    with torch.no_grad():
        got, (pad, seq) = layer(torch.from_numpy(tokens).long())
    np.testing.assert_array_equal(pad.numpy(), np.asarray(want_pad))
    np.testing.assert_array_equal(seq.numpy(), np.asarray(want_seq))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_lstm_cell_at_bf16_rounds_the_jax_output():
    """At bf16 parameters and input Flax's ``nn.RNN(OptimizedLSTMCell)``
    returns f32 (its carry: the recurrent product promoted, the input
    product in bf16); the port's cell computes the same and returns it
    rounded to bf16, so within half a bf16 ulp of the JAX output."""
    from flax import linen

    x = np.random.default_rng(3).normal(size=(3, 12, 16)).astype(np.float32)
    rnn = linen.RNN(linen.OptimizedLSTMCell(features=16))
    flat = {k.replace("params/", "params/lstm/", 1): v
            for k, v in _module_params(rnn, jnp.asarray(x)).items()}
    holder = torch.nn.Module()
    holder.lstm = FlaxLSTM(16)
    load_jax_params(holder, flat)
    params = {"params": traverse_util.unflatten_dict(flat, sep="/")["params"]["lstm"]}
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jax.jit(rnn.apply)(jax.tree.map(lambda a: a.astype(jnp.bfloat16), params), xb)
    assert want.dtype == jnp.float32
    want = np.asarray(want)
    with torch.no_grad():
        got = holder.lstm.to(torch.bfloat16)(
            torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    gap = np.abs(got.float().numpy() - want)
    assert (gap <= 0.5 * _bf16_ulp(want) + 1e-6).all(), gap.max()


def test_step_decode_and_its_lstm_restart_match_jax(pair):
    """Two decode steps within 2e-4 of JAX's.  The step restarts the LSTM
    (JAX ``decoders.py:461``, ``:645``): on both sides step 1's word
    embedding is the embedding of its one token alone, from the zero
    carry, not that of the prefix at position 1, which the teacher-forced
    pass uses.  (The steps differ from the teacher-forced positions for a
    second reason here: the MoE's capacity counts the call's tokens.)"""
    from openviic_tpu.models.base import make_decode_cache as jax_make_decode_cache
    from openviic_tpu_torch.models.base import make_decode_cache

    vocab, jax_model, model = pair["vocab"], pair["jax_model"], pair["port"]
    feats = make_features(3, seed=2)
    tokens = make_captions(vocab, 3, seed=2)
    batch = {"region_features": feats, "caption_tokens": tokens}

    def jax_side(params, batch):
        apply = jax_model.apply
        memory, mask = apply(params, {"region_features": batch["region_features"]},
                             method=jax_model.encoder_forward)
        cache = apply(params, jax_make_decode_cache(jax_model.config.DECODER, vocab, 3), memory,
                      method=jax_model.prepare_cache)
        step0, cache = apply(params, 0, batch["caption_tokens"][:, :1], cache, mask,
                             method=jax_model.decode_step)
        (step1, _), seen = apply(params, 1, batch["caption_tokens"][:, 1:2], cache, mask,
                                 method=jax_model.decode_step, capture_intermediates=True,
                                 mutable=["intermediates"])
        step_emb = seen["intermediates"]["decoder"]["word_emb"]["__call__"][0][0]

        def emb(tok):
            return apply(params, tok, method=lambda m, t: m.decoder.word_emb(t)[0])
        return (step0, step1, step_emb, emb(batch["caption_tokens"][:, 1:2]),
                emb(batch["caption_tokens"][:, :2]))

    *steps_, step_emb, alone, prefix = (
        np.asarray(a) for a in jax.jit(jax_side)(pair["params"], _jax(batch)))

    seen = []
    hook = model.decoder.word_emb.register_forward_hook(lambda m, i, out: seen.append(out[0]))
    try:
        with torch.no_grad():
            tmem, tmask = model.encoder_forward({"region_features": torch.from_numpy(feats)})
            cache = model.prepare_cache(make_decode_cache(model.config.DECODER, vocab, 3), tmem)
            for t in range(2):  # <bos>, then the first word
                step, cache = model.decode_step(t, torch.from_numpy(tokens[:, t:t + 1]).long(),
                                                cache, tmask)
                np.testing.assert_allclose(step.numpy(), steps_[t], atol=TF_ATOL, rtol=0)
    finally:
        hook.remove()
    with torch.no_grad():
        port_alone = model.decoder.word_emb(torch.from_numpy(tokens[:, 1:2]).long())[0]
        port_prefix = model.decoder.word_emb(torch.from_numpy(tokens[:, :2]).long())[0]
    torch.testing.assert_close(seen[1], port_alone, rtol=0, atol=0)
    np.testing.assert_array_equal(step_emb, alone)
    np.testing.assert_allclose(port_alone.numpy(), alone, atol=ATOL, rtol=0)
    for step_side, prefix_side in ((port_alone.numpy(), port_prefix.numpy()), (alone, prefix)):
        assert np.abs(step_side[:, 0] - prefix_side[:, 1]).min(axis=-1).max() > 0
        assert np.abs(step_side[:, 0] - prefix_side[:, 1]).max() > 100 * ATOL


def assert_decodes_equal(got, want):
    (got_o, got_l), (want_o, want_l) = got, want
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=BEAM_ATOL, rtol=0)


def test_fast_select_and_beam_search_multi_match_jax(pair, monkeypatch):
    """JAX's ``beam_search_multi`` over two batches (its fast-select path,
    which the JAX package's tests hold to its ``beam_search`` of each
    batch) against the port's ``beam_search`` of each batch and its
    ``beam_search_multi``: tokens equal, log-probs within 1e-4; the port's
    two equal bit for bit; some beam finished early (the -999
    continuation ran)."""
    for flag in ("OPENVIIC_PALLAS", "OPENVIIC_FUSED_STEP"):
        monkeypatch.delenv(flag, raising=False)
    model = pair["port"]
    batches = [{"region_features": make_features(bs, seed=bs + 1)} for bs in (3, 2)]
    want = jax.jit(lambda p, bs: jax_beam_search_multi(
        pair["jax_model"], p, bs, beam_size=BEAM, out_size=BEAM))(
        pair["params"], [_jax(b) for b in batches])
    multi = beam_search_multi(model, [_torch(b) for b in batches], beam_size=BEAM,
                              out_size=BEAM)
    assert len(multi) == len(want) == 2
    for batch, got, ref in zip(batches, multi, want):
        single = beam_search(model, _torch(batch), beam_size=BEAM, out_size=BEAM)
        assert_decodes_equal(single, ref)
        for a, b in zip(got, single):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert any((np.asarray(o)[..., :-1] == pair["vocab"].eos_idx).any() for o, _ in want)


def test_head_and_attention_kernels_match_jax(pair, monkeypatch):
    """The tuned path's two decode kernels (the port's plain versions, the
    JAX Pallas kernels in interpret mode): tokens equal, log-probs within
    1e-4."""
    for flag in ("OPENVIIC_PALLAS", "OPENVIIC_FUSED_STEP"):
        monkeypatch.delenv(flag, raising=False)
    feats = {"region_features": make_features(3, seed=4)}
    flags = dict(head_kernel=True, attn_kernel=True)
    want = jax.jit(lambda p, b: jax_beam_search(
        pair["jax_model"], p, b, beam_size=BEAM, out_size=BEAM, **flags))(
        pair["params"], _jax(feats))
    assert_decodes_equal(beam_search(pair["port"], _torch(feats), beam_size=BEAM,
                                     out_size=BEAM, **flags), want)


def test_layer_kernels_refuse_the_moe_decoder_as_jax_fails(pair, monkeypatch):
    """``resident_kernel`` and ``OPENVIIC_FUSED_STEP=1`` on the MoE
    decoder: the JAX package's gates let the layer in and its weight pack
    fails with an AttributeError; the port raises MOE_LAYER_KERNEL."""
    feats = {"region_features": make_features(2, seed=5)}
    monkeypatch.delenv("OPENVIIC_PALLAS", raising=False)
    monkeypatch.delenv("OPENVIIC_FUSED_STEP", raising=False)
    for env, flags in ((None, dict(resident_kernel=True)),
                       ("OPENVIIC_FUSED_STEP", dict(beam_resident=False))):
        if env:
            monkeypatch.setenv(env, "1")
        with pytest.raises(AttributeError, match='has no attribute "fc1"'):
            jax.jit(lambda p, b: jax_beam_search(pair["jax_model"], p, b, beam_size=BEAM,
                                                 **flags))(pair["params"], _jax(feats))
        with pytest.raises(ValueError) as exc:
            beam_search(pair["port"], _torch(feats), beam_size=BEAM, **flags)
        assert str(exc.value) == MOE_LAYER_KERNEL and "decoders.py:183" in str(exc.value)


def test_return_probs_matches_jax(pair):
    """``return_probs``: the tokens, log-probs and kept distributions equal
    JAX's (non-resident), with the head kernel asked for (it falls back,
    as in JAX) and without; the best beam's word log-prob at each step
    sits in some slot's kept distribution at its word (the distributions
    keep each step's slot order, as in the reference)."""
    vocab, model = pair["vocab"], pair["port"]
    feats = {"region_features": make_features(2, seed=6)}
    want = jax.jit(lambda p, b: jax_beam_search(pair["jax_model"], p, b, beam_size=BEAM,
                                                out_size=BEAM, return_probs=True))(
        pair["params"], _jax(feats))
    got = beam_search(model, _torch(feats), beam_size=BEAM, out_size=BEAM, return_probs=True,
                      head_kernel=True)
    plain = beam_search(model, _torch(feats), beam_size=BEAM, out_size=BEAM, return_probs=True)
    assert got[2].shape == (2, BEAM, vocab.max_caption_length, len(vocab))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for i in (1, 2):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), atol=BEAM_ATOL, rtol=0)
        torch.testing.assert_close(got[i], plain[i], rtol=0, atol=0)
    words = got[0][:, 0]  # (bs, L) the best beam's
    at_words = torch.gather(got[2], 3, words[:, None, :, None].expand(-1, BEAM, -1, 1))[..., 0]
    assert (at_words == got[1][:, 0][:, None, :]).any(dim=1).all()


def test_teacher_forced_xe_loss_and_gradients_match_jax(pair):
    """The teacher-forced log-probs of the model within 2e-4 (eval mode);
    one f32 XE step at dropout 0: the loss within 1e-5 relative, every
    gradient leaf (the stacked experts, the routers and the LSTM cell
    among them) within 1e-4 of its max-abs."""
    vocab, jax_model = pair["vocab"], pair["jax_model"]
    rng = np.random.default_rng(5)
    L = vocab.max_caption_length
    tokens = np.full((4, L), vocab.padding_idx, np.int32)
    target = tokens.copy()
    for i in range(4):
        n = 2 + 2 * i
        enc = np.concatenate([[vocab.bos_idx], rng.integers(4, len(vocab), size=n),
                              [vocab.eos_idx]])
        tokens[i, : n + 1], target[i, : n + 1] = enc[:-1], enc[1:]
    batch = {"region_features": make_features(4, seed=5), "caption_tokens": tokens,
             "shifted_right_caption_tokens": target}

    def loss_fn(params, b):  # the JAX model in eval mode: no dropout
        logits = jax_model.apply(params, b, raw_logits=True)
        loss = jax_steps.fused_nll(logits, b["shifted_right_caption_tokens"], vocab.padding_idx)
        return loss, jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)

    (want_loss, want_tf), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        pair["params"], _jax(batch))
    with torch.no_grad():
        got_tf = pair["port"](_torch(batch)).numpy()
    keep = tokens != vocab.padding_idx
    np.testing.assert_allclose(got_tf[keep], np.asarray(want_tf)[keep], atol=TF_ATOL, rtol=0)

    want = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(grads, sep="/").items()}
    model = load_jax_params(build_port_model(ConfigNode(moe_lstm_config(dropout=0.0)), vocab,
                                             device="cpu"), pair["flat"])
    _, loss = steps.make_xe_step(model)(port_state(model, d_model=16), _torch(batch))
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    errors = assert_grads_match(model, want, GRAD_TOL, pair["flat"])
    assert sum(k.endswith(("/w1", "/w2", "/b1", "/b2")) for k in errors) == 4 * 4
    assert sum("/lstm/cell/" in k for k in errors) == 12
