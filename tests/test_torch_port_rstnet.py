"""RSTNet (``configs/rstnet_fixed.yaml``'s adaptive decoder and frozen
language model) in the port against the JAX package at f32 on the CPU,
same weights (``tests/torch_port_rstnet.py``): the adaptive attention, both
language-model backbones, ``BERTModel`` and ``PhoBERTModel``, the signal
table, the decoder teacher-forced in both signal modes and step by step,
and the beam decode with and without the table, with the decode flags that
turn off for this decoder and ``OPENVIIC_PALLAS``.

Tolerances: the modules 1e-5 (the same f32 operations, sums in another
order), the log-probs 2e-4 and the step against JAX 2e-4 (the port's
parity bar, ``tests/test_torch_port_model.py``), beam decodes tokens equal
and log-probs within 1e-4 (``tests/torch_port_families.py``'s bar); the
table's decode against the per-step language model's: tokens equal and
log-probs within 1e-6 (the JAX package's own bar,
``tests/test_beam_search_variants.py``)."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from openviic_tpu.builders import build_attention as build_jax_attention
from openviic_tpu.builders import (
    build_pretrained_language_model as build_jax_language_model,
)
from openviic_tpu.config import ConfigNode as JaxConfigNode
from openviic_tpu.decoding import beam_search as jax_beam_search
from openviic_tpu.models.base import make_decode_cache as jax_make_decode_cache
from openviic_tpu_torch.builders import build_attention, build_pretrained_language_model
from openviic_tpu_torch.compat.from_jax import load_jax_params
from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.decoding import beam_search
from openviic_tpu_torch.models.base import make_decode_cache
from openviic_tpu_torch.models.initializers import initialize
from tests.helpers import attention_config
from tests.test_torch_port_support import make_captions, make_features
from tests.torch_port_rstnet import (
    LM_VOCAB,
    jax_batch,
    make_rstnet,
    rstnet_model,
    torch_batch,
)

MODULE_ATOL = 1e-5
ATOL = 2e-4
BEAM_ATOL = 1e-4
TABLE_ATOL = 1e-6
BEAM = 3
BACKBONES = {"hf": True, "mini": False}
# scales the head's <eos> column so that some beams end early and the
# finished-beam (-999) continuation runs
EOS_GAIN = {"hf": -4.0, "mini": 6.0}


@functools.lru_cache(maxsize=None)
def rstnet(backbone: str, mode: str):
    return make_rstnet(BACKBONES[backbone], mode, eos_gain=EOS_GAIN[backbone])


def _numpy_params(template, seed):
    """Flat {"params/a/b": array} over ``template``'s shapes, drawn as
    ``random_params`` draws them."""
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
    return flat


def test_adaptive_attention_matches_jax():
    """Forward (K and V from ``keys``) and ``attend_cached`` (projected K/V)
    with a causal + key-padding mask, every query's language column."""
    config = attention_config("AdaptiveScaledDotProductAttention")
    rng = np.random.default_rng(0)
    queries, keys = (rng.normal(size=(2, n, 16)).astype(np.float32) for n in (5, 7))
    signals = rng.normal(size=(2, 5, 16)).astype(np.float32)
    mask = np.triu(np.ones((5, 7), bool), k=3)[None, None].repeat(2, 0)
    mask[1, ..., -2:] = True  # padded keys
    jax_att = build_jax_attention(JaxConfigNode(config))
    template = jax.eval_shape(jax_att.init, jax.random.PRNGKey(0), jnp.asarray(queries),
                              jnp.asarray(keys), jnp.asarray(keys), jnp.asarray(signals))
    flat = _numpy_params(template, 1)
    params = traverse_util.unflatten_dict(flat, sep="/")
    port = load_jax_params(build_attention(ConfigNode(config)), flat)
    want = jax_att.apply(params, jnp.asarray(queries), jnp.asarray(keys), jnp.asarray(keys),
                         jnp.asarray(signals), attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = port(torch.from_numpy(queries), torch.from_numpy(keys), torch.from_numpy(keys),
                   attention_mask=torch.from_numpy(mask),
                   language_signals=torch.from_numpy(signals))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODULE_ATOL, rtol=0)

    k, v = (rng.normal(size=(2, 7, 2, 8)).astype(np.float32) for _ in range(2))
    step_mask = mask[:, :, 2:3]
    want = jax_att.apply(params, jnp.asarray(queries[:, :1]), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(step_mask), language_signals=jnp.asarray(signals[:, :1]),
                         method=jax_att.attend_cached)
    with torch.no_grad():
        got = port.attend_cached(torch.from_numpy(queries[:, :1]), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(step_mask),
                                 language_signals=torch.from_numpy(signals[:, :1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODULE_ATOL, rtol=0)


@pytest.mark.parametrize("architecture", ["BERTModel", "PhoBERTModel"])
@pytest.mark.parametrize("backbone", list(BACKBONES))
def test_language_model_matches_jax(architecture, backbone):
    """Each family's language model alone on captions with <pad> (the
    ``prefix`` call) and on single ids (the ``token`` call, the <pad> id
    among them): the backbone's output, the log-probs and the feature."""
    config = rstnet_model(BACKBONES[backbone], architecture=architecture)
    config = config["DECODER"]["LANGUAGE_MODEL"]
    jax_lm = build_jax_language_model(JaxConfigNode(config))
    ids = np.zeros((3, 12), np.int32)  # <bos>, 5 ids of the language model's vocab, <pad>
    ids[:, 0] = 1
    ids[:, 1:6] = np.random.default_rng(3).integers(4, LM_VOCAB, size=(3, 5))
    template = jax.eval_shape(jax_lm.init, jax.random.PRNGKey(0), jnp.asarray(ids))
    flat = _numpy_params(template, 4)
    params = traverse_util.unflatten_dict(flat, sep="/")
    lm = build_pretrained_language_model(ConfigNode(config))
    load_jax_params(lm, flat)
    assert not any(p.requires_grad for p in lm.backbone.parameters())
    hf = "backbone/hf/pooler/dense/kernel" in "/".join(flat)
    assert hf == BACKBONES[backbone]
    for call in (ids, ids.reshape(-1, 1)):
        jids = jnp.asarray(call)
        want_lp, want_feat = jax_lm.apply(params, jids)
        want_hidden = jax_lm.apply(params, jids, method=lambda m, x: m.backbone(x))
        with torch.no_grad():
            tids = torch.from_numpy(call).long()
            got_lp, got_feat = lm(tids)
            got_hidden = lm.backbone(tids)
            signals = lm.signals(tids)
        np.testing.assert_allclose(got_hidden.numpy(), np.asarray(want_hidden),
                                   atol=MODULE_ATOL, rtol=0)
        np.testing.assert_allclose(got_feat.numpy(), np.asarray(want_feat), atol=MODULE_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), atol=MODULE_ATOL,
                                   rtol=0)
        torch.testing.assert_close(signals, got_feat, rtol=0, atol=0)


def test_initialisation_follows_the_jax_schemes():
    """Both backbones drawn by ``initialize``: the HF family's kernels and
    embeddings N(0, 0.02), zero biases; the mini backbone's lecun-normal
    kernels (variance 1 / fan_in, truncated at 2 sigma) and N(0, 1)
    embeddings."""
    hf = build_pretrained_language_model(ConfigNode(dict(
        rstnet_model(True)["DECODER"]["LANGUAGE_MODEL"], HIDDEN_SIZE=64, VOCAB_SIZE=4000)))
    initialize(hf, torch.Generator().manual_seed(0))
    words = hf.backbone.hf.embeddings.word_embeddings.weight
    query = hf.backbone.hf.encoder.layer[0].attention.self.query
    assert abs(float(words.std()) - 0.02) < 0.001 and abs(float(query.weight.std()) - 0.02) < 0.002
    assert not query.bias.any()
    mini = build_pretrained_language_model(ConfigNode(dict(
        rstnet_model(False)["DECODER"]["LANGUAGE_MODEL"], HIDDEN_SIZE=64, VOCAB_SIZE=4000)))
    initialize(mini, torch.Generator().manual_seed(0))
    ff1 = mini.backbone.ff1_0.weight
    std = np.sqrt(1 / 64) / 0.87962566103423978
    assert float(ff1.abs().max()) <= 2 * std and abs(float(ff1.var()) * 64 - 1.0) < 0.05
    assert abs(float(mini.backbone.tok_emb.weight.std()) - 1.0) < 0.02


@pytest.mark.parametrize("backbone", list(BACKBONES))
def test_signal_table_matches_jax(backbone):
    """Every row, the <pad> row included (zero: the encoder layer zeroes
    its masked query), against the JAX ``compute_language_table``."""
    m = rstnet(backbone, "token")
    want = np.asarray(m.jax_model.apply(m.jax_params, method=m.jax_model.compute_language_table))
    got = m.port_model.compute_language_table()
    assert got.shape == (len(m.vocab), 16) and not got.requires_grad
    assert np.isfinite(want).all() and not got[m.vocab.padding_idx].any()
    np.testing.assert_allclose(got.numpy(), want, atol=MODULE_ATOL, rtol=0)


@pytest.mark.parametrize("backbone,mode", [("hf", "token"), ("hf", "prefix"), ("mini", "token")])
def test_teacher_forced_log_probs_match_jax(backbone, mode):
    m = rstnet(backbone, mode)
    batch = {"region_features": make_features(3, seed=1),
             "caption_tokens": make_captions(m.vocab, 3, n_words=5, seed=2)}
    want = np.asarray(jax.jit(m.jax_model.apply)(m.jax_params, jax_batch(batch)))
    with torch.no_grad():
        got = m.port_model(torch_batch(batch)).numpy()
    keep = batch["caption_tokens"] != m.vocab.padding_idx
    assert got.shape == want.shape == (3, m.vocab.max_caption_length, len(m.vocab))
    np.testing.assert_allclose(got[keep], want[keep], atol=ATOL, rtol=0)


def test_step_decode_matches_jax_with_and_without_the_table():
    """Six steps of ``decode_step`` (the last on a <pad> input) against the
    JAX step, with the per-step language model and with the table in the
    cache; the two port paths within TABLE_ATOL, absolute and relative, of
    each other."""
    m = rstnet("hf", "token")
    model, vocab = m.port_model, m.vocab
    feats = make_features(2, seed=3)
    tokens = make_captions(vocab, 2, n_words=4, seed=3)
    memory, memory_mask = m.jax_model.apply(m.jax_params, jax_batch({"region_features": feats}),
                                            method=m.jax_model.encoder_forward)
    jax_step = jax.jit(functools.partial(m.jax_model.apply, method=m.jax_model.decode_step))
    table = model.compute_language_table()
    jtable = m.jax_model.apply(m.jax_params, method=m.jax_model.compute_language_table)
    outs = {}
    for with_table in (False, True):
        jcache = jax_make_decode_cache(m.jax_model.config.DECODER, vocab, 2)
        jcache = m.jax_model.apply(m.jax_params, jcache, memory, method=m.jax_model.prepare_cache)
        if with_table:
            jcache["language_table"] = jtable
        with torch.no_grad():
            tmem, tmask = model.encoder_forward(torch_batch({"region_features": feats}))
            cache = model.prepare_cache(make_decode_cache(model.config.DECODER, vocab, 2), tmem)
            assert len(cache["layers"]) == 3  # 2 standard layers and the adaptive one
            if with_table:
                cache["language_table"] = table
            steps = []
            for t in range(6):
                step, cache = model.decode_step(t, torch.from_numpy(tokens[:, t:t + 1]).long(),
                                                cache, tmask)
                jstep, jcache = jax_step(m.jax_params, t, jnp.asarray(tokens[:, t:t + 1]),
                                         jcache, memory_mask)
                np.testing.assert_allclose(step.numpy(), np.asarray(jstep), atol=ATOL, rtol=0,
                                           err_msg=f"step {t}, table {with_table}")
                steps.append(step.numpy())
        outs[with_table] = np.stack(steps)
    # the table's rows come from one (vocab, 1) call, the step's signals from
    # a (2, 1) call: the same f32 operations in other batch shapes, a few
    # ulps apart at log-probs of magnitude ~8
    np.testing.assert_allclose(outs[True], outs[False], atol=TABLE_ATOL, rtol=TABLE_ATOL)


def test_beam_decode_matches_jax_with_and_without_the_table():
    """Beam 3, every beam kept: the port's decode with the per-step language
    model and with the table, each with JAX's tokens and log-probs, and
    equal to each other; some beams end early (the -999 continuation).  The
    backbone matters only through the signals, held for both above."""
    m = rstnet("hf", "token")
    feats = {"region_features": make_features(3, seed=4)}
    table = m.port_model.compute_language_table()
    jtable = m.jax_model.apply(m.jax_params, method=m.jax_model.compute_language_table)
    got, want = {}, {}
    for key, (t_port, t_jax) in {"step_lm": (None, None), "table": (table, jtable)}.items():
        got[key] = beam_search(m.port_model, torch_batch(feats), beam_size=BEAM, out_size=BEAM,
                               language_table=t_port)
        want[key] = jax_beam_search(m.jax_model, m.jax_params, jax_batch(feats),
                                    beam_size=BEAM, out_size=BEAM, language_table=t_jax)
        np.testing.assert_array_equal(got[key][0].numpy(), np.asarray(want[key][0]))
        np.testing.assert_allclose(got[key][1].numpy(), np.asarray(want[key][1]), atol=BEAM_ATOL,
                                   rtol=0)
    torch.testing.assert_close(got["table"][0], got["step_lm"][0], rtol=0, atol=0)
    torch.testing.assert_close(got["table"][1], got["step_lm"][1], rtol=0, atol=TABLE_ATOL)
    outs = got["table"][0].numpy()
    assert (outs[..., :-1] == m.vocab.eos_idx).any()


def count_calls(monkeypatch, targets):
    """{name: [calls]} of the functions ``targets`` {name: module} (each
    still runs)."""
    calls = {}
    for name, module in targets.items():
        real = getattr(module, name)
        calls[name] = []

        def wrapper(*args, _seen=calls[name], _real=real, **kwargs):
            _seen.append(1)
            return _real(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapper)
    return calls


def _kernel_wrappers():
    import openviic_tpu_torch.models.attention as attention_module
    import openviic_tpu_torch.models.decoders as decoders_module

    beam_module = importlib.import_module("openviic_tpu_torch.decoding.beam_search")
    return {"head_topk": beam_module, "beam_select_attention": attention_module,
            "resident_layer_step": decoders_module, "fused_layer_step": decoders_module,
            "fused_attention": attention_module}


def test_decode_flags_launch_no_step_kernel(monkeypatch):
    """``resident_kernel``, ``head_kernel``, ``attn_kernel`` and
    ``OPENVIIC_FUSED_STEP=1`` turn off for the adaptive decoder, as in the
    JAX package: no call of the four step kernels, the decode equal to the
    default one."""
    m = rstnet("hf", "token")
    feats = torch_batch({"region_features": make_features(2, seed=5)})
    table = m.port_model.compute_language_table()
    monkeypatch.delenv("OPENVIIC_PALLAS", raising=False)
    want = beam_search(m.port_model, feats, beam_size=BEAM, language_table=table)
    calls = count_calls(monkeypatch, _kernel_wrappers())
    for flags in (dict(resident_kernel=True), dict(head_kernel=1), dict(attn_kernel=True),
                  dict(beam_resident=False, fused=True)):
        if flags.pop("fused", False):
            monkeypatch.setenv("OPENVIIC_FUSED_STEP", "1")
        got = beam_search(m.port_model, feats, beam_size=BEAM, language_table=table, **flags)
        monkeypatch.delenv("OPENVIIC_FUSED_STEP", raising=False)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert all(not c for c in calls.values()), {k: len(v) for k, v in calls.items()}


def test_signal_paths_never_run_the_vocab_head():
    """The table, the teacher-forced pass in both modes and the decodes with
    and without the table call the language model's ``signals`` only: its
    ``proj_to_vocab`` (the (rows, VOCAB_SIZE) log-probs) runs nowhere."""
    calls = []
    for mode in ("token", "prefix"):
        m = rstnet("hf", mode)
        hook = m.port_model.decoder.language_model.proj_to_vocab.register_forward_hook(
            lambda *_: calls.append(1))
        try:
            feats = make_features(2, seed=6)
            batch = {"region_features": feats, "caption_tokens": make_captions(m.vocab, 2)}
            with torch.no_grad():
                m.port_model(torch_batch(batch))
            table = m.port_model.compute_language_table()
            for t in (None, table):
                beam_search(m.port_model, torch_batch({"region_features": feats}), beam_size=2,
                            language_table=t)
            assert not calls
            with torch.no_grad():  # the module's own forward does run it
                m.port_model.decoder.language_model(torch.ones((1, 1), dtype=torch.long))
            assert len(calls) == 1
        finally:
            hook.remove()
            calls.clear()


def test_pallas_runs_fused_attention_where_jax_does(monkeypatch):
    """``OPENVIIC_PALLAS``: fused_attention once an encoder layer, twice a
    standard decoder layer and step, once a table build and, without the
    table, once a step for the language model's encoder layer (its 1 x 1
    calls, the <pad> row's fully masked); the adaptive layer launches
    none.  The decode equals JAX's with its Pallas kernel in interpret
    mode, with the table."""
    m = rstnet("hf", "token")
    monkeypatch.setenv("OPENVIIC_PALLAS", "interpret")
    calls = count_calls(monkeypatch, _kernel_wrappers())
    feats = {"region_features": make_features(2, seed=7)}
    table = m.port_model.compute_language_table()
    assert len(calls["fused_attention"]) == 1
    n_enc, n_std = len(m.port_model.encoder.layers), len(m.port_model.decoder.layers) - 1
    L = m.vocab.max_caption_length
    for t, per_step in ((None, 2 * n_std + 1), (table, 2 * n_std)):
        calls["fused_attention"].clear()
        got = beam_search(m.port_model, torch_batch(feats), beam_size=BEAM, out_size=BEAM,
                          language_table=t, early_exit=False)
        assert len(calls["fused_attention"]) == n_enc + L * per_step
    jtable = m.jax_model.apply(m.jax_params, method=m.jax_model.compute_language_table)
    want = jax_beam_search(m.jax_model, m.jax_params, jax_batch(feats), beam_size=BEAM,
                           out_size=BEAM, language_table=jtable, early_exit=False)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=BEAM_ATOL, rtol=0)
    assert not any(calls[k] for k in calls if k != "fused_attention")
