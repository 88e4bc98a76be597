"""The port's non-resident beam search (the JAX package's default path:
encoder memory expanded to beams, full log-softmax distributions through
the -999 continuation and ``_select_topk``, the whole cache reordered every
step) against the JAX ``beam_search(beam_resident=False)`` at f32 on the
CPU, with and without ``OPENVIIC_FUSED_STEP`` (the fused layer step's plain
version here); and how the decode flags combine.

Tokens must be identical; per-step word log-probs agree within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openviic_tpu_torch.models.attention as port_attention
import openviic_tpu_torch.models.decoders as port_decoders
from openviic_tpu.decoding import beam_search as jax_beam_search
from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.decoding import beam_search
from openviic_tpu_torch.serving import CaptioningPipeline
from tests.helpers import model_config
from tests.test_torch_port_support import D_FEATURE, make_features, make_pair, make_vocab

ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    vocab = make_vocab()
    return (vocab,) + make_pair(vocab, seed=6, eos_gain=6.0)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused_step"])
@pytest.mark.parametrize("beam_size", [1, 3, 5])
def test_nonresident_decode_matches_jax(pair, beam_size, fused, monkeypatch):
    vocab, jax_model, jax_params, port_model = pair
    if fused:
        monkeypatch.setenv("OPENVIIC_FUSED_STEP", "1")
    else:
        monkeypatch.delenv("OPENVIIC_FUSED_STEP", raising=False)
    # 3 images: the JAX fused kernel takes row counts below 16 or multiples of 16
    feats = make_features(3, seed=50 + beam_size)
    want_o, want_l = jax_beam_search(
        jax_model, jax_params, {"region_features": jnp.asarray(feats)},
        beam_size=beam_size, out_size=beam_size, beam_resident=False,
    )
    got_o, got_l = beam_search(
        port_model, {"region_features": torch.from_numpy(feats)},
        beam_size=beam_size, out_size=beam_size, beam_resident=False,
    )
    want_o = np.asarray(want_o).reshape(got_o.shape)
    np.testing.assert_array_equal(got_o.numpy(), want_o)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l).reshape(got_l.shape),
                               atol=ATOL, rtol=0)
    if beam_size > 1:
        assert (want_o[..., :-1] == vocab.eos_idx).any()  # the -999 continuation ran


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nonresident_matches_beam_resident(pair, seed):
    """The counterpart of the JAX package's
    ``test_beam_resident_matches_default``, on the port."""
    _, _, _, port_model = pair
    batch = {"region_features": torch.from_numpy(make_features(3, seed=60 + seed))}
    ref_o, ref_l = beam_search(port_model, batch, beam_size=5, out_size=5, beam_resident=False)
    got_o, got_l = beam_search(port_model, batch, beam_size=5, out_size=5, beam_resident=True)
    np.testing.assert_array_equal(got_o.numpy(), ref_o.numpy())
    np.testing.assert_allclose(got_l.numpy(), ref_l.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_select_topk_matches_jax(seed):
    """``_select_topk`` on candidates with many exact ties, -999 rows and
    the t=0 -1e18 rows: the flattened argsort's tie order."""
    from openviic_tpu.decoding.beam_search import _select_topk as jax_select
    from openviic_tpu_torch.decoding.beam_search import _select_topk

    rng = np.random.default_rng(seed)
    cand = (np.round(rng.normal(size=(3, 4, 300)) * 2) / 2).astype(np.float32)
    cand[0, 1:] = -1e18
    cand[1, 2, 1:] = -999.0
    want = jax_select(jnp.asarray(cand), 4)
    got = _select_topk(torch.from_numpy(cand), 4)
    for name, g, w in zip(("logprob", "beam", "words"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_cache_reorder_is_an_index_gather():
    from openviic_tpu_torch.decoding.beam_search import _reorder_rows

    x = torch.arange(2 * 3 * 4).reshape(6, 4)
    selected = torch.tensor([[2, 2, 0], [1, 0, 1]])
    want = torch.stack([x[2], x[2], x[0], x[4], x[3], x[4]])
    assert torch.equal(_reorder_rows(x, selected), want)


def test_nonresident_ids_stay_in_range_at_a_large_vocab():
    vocab = make_vocab(size=7094, max_len=8)
    _, _, port_model = make_pair(vocab, seed=4, eos_gain=0.5)
    batch = {"region_features": torch.from_numpy(make_features(2, seed=7))}
    outs, _ = beam_search(port_model, batch, beam_size=5, out_size=5, beam_resident=False,
                          compute_dtype=torch.bfloat16)
    assert outs.min() >= 0 and outs.max() < len(vocab)
    assert outs.max() > 2048


class _Calls:
    """Counts calls of a function that a module imported, and passes them on."""

    def __init__(self, monkeypatch, module, name):
        self.n = 0
        fn = getattr(module, name)

        def counted(*args, **kwargs):
            self.n += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize(
    "flags,resident_calls,attn_calls,fused_calls",
    [
        (dict(resident_kernel=True), 1, 0, 0),
        (dict(attn_kernel=True), 0, 1, 0),
        # both: the attention option keeps the unfused layer step, whose
        # self-attention runs through the beam-select kernel (the JAX
        # package's precedence, decoders.py:118-128)
        (dict(resident_kernel=True, attn_kernel=True), 0, 1, 0),
        (dict(beam_resident=False, fused=True), 0, 0, 1),
        # the fused step serves only the non-resident path
        (dict(beam_resident=True, fused=True), 0, 0, 0),
        (dict(beam_resident=False), 0, 0, 0),
    ],
    ids=["resident", "attn", "resident+attn", "fused", "fused_flag_on_resident", "plain"],
)
def test_decode_flags_pick_the_kernel_paths(pair, monkeypatch, flags, resident_calls,
                                            attn_calls, fused_calls):
    """Calls per decoder layer and decode step of each kernel wrapper (here
    their plain versions), for each combination of flags."""
    vocab, _, _, port_model = pair
    flags = dict(flags)
    if flags.pop("fused", False):
        monkeypatch.setenv("OPENVIIC_FUSED_STEP", "1")
    else:
        monkeypatch.delenv("OPENVIIC_FUSED_STEP", raising=False)
    resident = _Calls(monkeypatch, port_decoders, "resident_layer_step")
    fused = _Calls(monkeypatch, port_decoders, "fused_layer_step")
    attn = _Calls(monkeypatch, port_attention, "beam_select_attention")
    batch = {"region_features": torch.from_numpy(make_features(2, seed=70))}
    from openviic_tpu_torch.decoding.beam_search import _beam_search

    _, _, steps = _beam_search(port_model, batch, 3, 1, True, None,
                               flags.get("beam_resident", True), False,
                               flags.get("attn_kernel", False),
                               flags.get("resident_kernel", False))
    layer_steps = len(port_model.decoder.layers) * steps
    assert steps > 0
    assert (resident.n, attn.n, fused.n) == (
        resident_calls * layer_steps, attn_calls * layer_steps, fused_calls * layer_steps
    )


def test_pipeline_honours_decode_attn_kernel(monkeypatch):
    """``TRAINING.DECODE_ATTN_KERNEL`` runs every decoder self-attention
    step through the beam-select kernel (here its plain version), as the
    JAX pipeline does, and the captions equal the JAX decode with
    ``attn_kernel=True`` at f32."""
    vocab = make_vocab()
    jax_model, jax_params, port_model = make_pair(vocab, seed=5, eos_gain=6.0)
    config = ConfigNode({
        "MODEL": model_config(d_feature=D_FEATURE).to_dict(),
        "TRAINING": {"EVALUATING_BEAM_SIZE": 3, "DECODE_ATTN_KERNEL": True},
    })
    pipe = CaptioningPipeline.from_state_dict(config, vocab, state_dict=port_model.state_dict(),
                                              batch_size=4, use_bf16=False, device="cpu")
    assert pipe.searcher.attn_kernel and not pipe.searcher.head_kernel
    attn = _Calls(monkeypatch, port_attention, "beam_select_attention")
    feats = make_features(4, n_regions=8, seed=80)
    captions, ids = pipe.caption_features([{"region_features": f} for f in feats],
                                          return_ids=True)
    assert attn.n == len(port_model.decoder.layers) * pipe.searcher.steps > 0
    want, _ = jax_beam_search(jax_model, jax_params, {"region_features": jnp.asarray(feats)},
                              beam_size=3, attn_kernel=True)
    np.testing.assert_array_equal(ids, np.asarray(want))
    assert captions == vocab.decode_caption(np.asarray(want))
