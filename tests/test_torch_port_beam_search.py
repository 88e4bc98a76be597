"""The port's beam-resident beam search against the JAX package at float32 on
the CPU, same weights, for both selection branches: fast select and the
fused head + lse + top-k (its plain version here; the CUDA kernel is held
against that on the card by ``chip_smoke.py``).

Tokens must be identical; per-step word log-probs agree within 2e-4.  The
head's <eos> column is scaled up so that beams finish at different steps,
which exercises the finished-beam (-999) continuation and early exit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openviic_tpu.decoding import beam_search as jax_beam_search
from openviic_tpu_torch.decoding import BeamSearcher, beam_search
from tests.test_torch_port_support import make_features, make_pair, make_vocab

ATOL = 2e-4


@pytest.fixture(scope="module")
def pair():
    vocab = make_vocab()
    return (vocab,) + make_pair(vocab, seed=2, eos_gain=6.0)


@pytest.mark.parametrize("head_kernel", [False, True], ids=["fast_select", "head_kernel"])
@pytest.mark.parametrize("beam_size", [1, 3, 5])
def test_beam_search_matches_jax(pair, beam_size, head_kernel):
    vocab, jax_model, jax_params, port_model = pair
    feats = make_features(4, seed=beam_size)
    want_o, want_l = jax_beam_search(
        jax_model, jax_params, {"region_features": jnp.asarray(feats)},
        beam_size=beam_size, out_size=beam_size, beam_resident=True,
        head_kernel=head_kernel,
    )
    got_o, got_l = beam_search(
        port_model, {"region_features": torch.from_numpy(feats)},
        beam_size=beam_size, out_size=beam_size, head_kernel=head_kernel,
    )
    want_o = np.asarray(want_o).reshape(got_o.shape)
    want_l = np.asarray(want_l).reshape(got_l.shape)
    np.testing.assert_array_equal(got_o.numpy(), want_o)
    np.testing.assert_allclose(got_l.numpy(), want_l, atol=ATOL, rtol=0)
    if beam_size > 1:
        # some beams emitted <eos> before the last step
        assert (want_o[..., :-1] == vocab.eos_idx).any()


@pytest.mark.parametrize("head_kernel", [False, True], ids=["fast_select", "head_kernel"])
def test_out_size_one_returns_the_best_beam(pair, head_kernel):
    vocab, jax_model, jax_params, port_model = pair
    feats = make_features(3, seed=11)
    want_o, want_l = jax_beam_search(
        jax_model, jax_params, {"region_features": jnp.asarray(feats)},
        beam_size=5, out_size=1, beam_resident=True, head_kernel=head_kernel,
    )
    got_o, got_l = beam_search(port_model, {"region_features": torch.from_numpy(feats)},
                               beam_size=5, head_kernel=head_kernel)
    assert got_o.shape == (3, vocab.max_caption_length)
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=ATOL, rtol=0)


def test_early_exit_changes_no_output():
    vocab = make_vocab()
    _, _, port_model = make_pair(vocab, seed=2, eos_gain=20.0)
    # an image whose beams all emit <eos> within the first steps
    batch = {"region_features": torch.from_numpy(make_features(4, seed=5)[:1])}
    full = beam_search(port_model, batch, beam_size=3, out_size=3, early_exit=False)
    searcher = BeamSearcher(port_model)
    early = searcher(batch, beam_size=3, out_size=3)
    assert 2 <= searcher.steps < vocab.max_caption_length
    assert torch.equal(full[0], early[0]) and torch.equal(full[1], early[1])


def test_bf16_compute_leaves_the_callers_model_in_f32(pair):
    _, _, _, port_model = pair
    batch = {"region_features": torch.from_numpy(make_features(2, seed=6))}
    outs, lps = beam_search(port_model, batch, beam_size=3, compute_dtype=torch.bfloat16,
                            head_kernel=True)
    assert next(port_model.parameters()).dtype == torch.float32
    assert lps.dtype == torch.float32 and torch.isfinite(lps).all()


@pytest.mark.parametrize("head_kernel", [False, True], ids=["fast_select", "head_kernel"])
def test_large_vocab_ids_stay_in_range(head_kernel):
    """At the trained artifact's vocab size (7 094) every decoded id lies in
    the vocab: beam state moves by index gathers, never through a
    low-precision product (ids above 256 once came back corrupted that way
    in the JAX package)."""
    vocab = make_vocab(size=7094, max_len=10)
    _, _, port_model = make_pair(vocab, seed=4, eos_gain=0.5)
    batch = {"region_features": torch.from_numpy(make_features(3, seed=7))}
    outs, _ = beam_search(port_model, batch, beam_size=5, out_size=5,
                          compute_dtype=torch.bfloat16, head_kernel=head_kernel)
    assert outs.min() >= 0 and outs.max() < len(vocab)
    assert outs.max() > 2048  # ids in the range a one-hot product in TF32 would corrupt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_selection_functions_match_jax(seed):
    """_select_topk_hier and _finish_select on crafted candidates: a vocab
    that is not a multiple of the tile, exact ties, finished beams, and
    sequence log-probs on both sides of -999 and at the t=0 -1e18."""
    from openviic_tpu.decoding.beam_search import _select_topk_hier as jax_select
    from openviic_tpu_torch.decoding.beam_search import _select_topk_hier

    rng = np.random.default_rng(seed)
    bs, beam, V = 3, 4, 1100
    logits = np.round(rng.normal(size=(bs, beam, V)) * 4) / 4  # many exact ties
    logits = logits.astype(np.float32)
    offset = rng.normal(size=(bs, beam)).astype(np.float32)
    finished = rng.random(size=(bs, beam)) < 0.4
    finished[0] = True  # an image whose beams all ended: only -999 candidates compete
    seq_logprob = rng.choice([-3.5, -500.0, -999.0, -1500.0, -1e18], size=(bs, beam)).astype(np.float32)
    want = jax_select(jnp.asarray(logits), jnp.asarray(offset), jnp.asarray(finished),
                      jnp.asarray(seq_logprob), beam)
    got = _select_topk_hier(torch.from_numpy(logits), torch.from_numpy(offset),
                            torch.from_numpy(finished), torch.from_numpy(seq_logprob), beam)
    for name, g, w in zip(("logprob", "beam", "words", "logit"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
