"""Three repairs of the port against the JAX package, on the CPU:

1. ``head_kernel=True`` is an auto gate in ``BeamSearcher`` (resolved per
   call through the port's own H100 thresholds, ``_head_kernel_wins``), an
   int that is not a bool forces the kernel, ``False`` never runs it, and
   ``CaptioningPipeline`` keeps the int;
2. the head kernel takes 1 <= k <= min(128, V), as the JAX kernel does: the
   plain version against JAX ``head_topk`` at k = 32 and 128, and the
   wrapper's operand check;
3. the port's bf16 decode against the JAX package's bf16 decode, with the
   tokens forced (see ``test_bf16_forced_decode_against_jax``), and the
   same with XLA's excess precision off (``test_bf16_gap_is_xla_excess_
   precision``): the gap's source is the reference's CPU compiler."""

import functools
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openviic_tpu.decoding import beam_search as jax_beam_search
from openviic_tpu.models.base import make_decode_cache as jax_make_decode_cache
from openviic_tpu.ops.head_topk import head_topk as jax_head_topk
from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.decoding import BeamSearcher, beam_search as port_beam_search
from openviic_tpu_torch.decoding.beam_search import _head_kernel_wins
from openviic_tpu_torch.models.base import make_decode_cache
from openviic_tpu_torch.ops import head_topk as head_ops
from openviic_tpu_torch.serving import CaptioningPipeline
from tests.helpers import model_config
from tests.test_torch_port_support import D_FEATURE, make_features, make_pair, make_vocab

REPO_ROOT = Path(__file__).resolve().parent.parent
# the module (the package's ``beam_search`` name is the function)
beam_search_module = importlib.import_module("openviic_tpu_torch.decoding.beam_search")


# ------------------------------------------------------------------ 1. the gate
@pytest.mark.parametrize("b_s,beam,wins", [
    (1, 1, True), (640, 1, True),      # greedy: the kernel won from one image on the H100
    (1, 5, True), (320, 5, True),      # the served beam, one image to the serve batch
    (1, 16, True), (200, 16, True),    # the largest beam swept
    (100, 17, False), (320, 128, False),  # k > 16: the shared-memory lists, never auto
])
def test_gate_holds_the_measured_thresholds(b_s, beam, wins):
    assert _head_kernel_wins(b_s, beam) is wins


def _spy(monkeypatch):
    """Count calls of the head kernel's wrapper inside the beam search."""
    calls = []
    real = beam_search_module.head_topk

    def spy(x, w, k):
        calls.append(k)
        return real(x, w, k)

    monkeypatch.setattr(beam_search_module, "head_topk", spy)
    return calls


@pytest.fixture(scope="module")
def pair():
    vocab = make_vocab()
    return (vocab,) + make_pair(vocab, seed=3, eos_gain=6.0)


@pytest.mark.parametrize("head_kernel,b_s,beam,expected", [
    (True, 32, 5, True), (True, 2, 17, False), (1, 2, 17, True), (2, 2, 5, True),
    (False, 32, 5, False), (0, 32, 5, False),
], ids=["auto_large", "auto_small", "int_1", "int_2", "false", "int_0"])
def test_searcher_resolves_the_gate_per_call(pair, monkeypatch, head_kernel, b_s, beam,
                                             expected):
    """``auto_small`` is beam 17, where the auto gate keeps fast select (on
    the H100 the kernel won at every batch at beams up to 16); an int
    forces the kernel there too."""
    _, _, _, port_model = pair
    calls = _spy(monkeypatch)
    searcher = BeamSearcher(port_model, head_kernel=head_kernel)
    batch = {"region_features": torch.from_numpy(make_features(b_s, seed=8))}
    assert searcher.effective_head_kernel(batch, beam) is expected
    searcher(batch, beam_size=beam)
    assert bool(calls) is expected and all(k == beam for k in calls)
    assert searcher.head_kernel is head_kernel  # kept as given, not cast to bool


@pytest.mark.parametrize("beam", [3, 17])
def test_auto_gate_decodes_like_jax_auto_gate(pair, beam):
    """``BeamSearcher(head_kernel=True)`` at 2 images.  At beam 3 the port's
    H100 gate takes the kernel where the JAX package's v5e gate would not,
    so the reference is the JAX kernel, forced; at beam 17 both gates keep
    fast select, and the reference is the JAX ``BeamSearcher``'s own auto
    gate."""
    from openviic_tpu.decoding import BeamSearcher as JaxBeamSearcher

    vocab, jax_model, jax_params, port_model = pair
    feats = make_features(2, seed=9)
    batch = {"region_features": jnp.asarray(feats)}
    if beam <= 16:
        want, _ = jax_beam_search(jax_model, jax_params, batch, beam_size=beam, head_kernel=True)
    else:
        want, _ = JaxBeamSearcher(jax_model, head_kernel=True)(jax_params, batch, beam_size=beam)
    got, _ = BeamSearcher(port_model, head_kernel=True)(
        {"region_features": torch.from_numpy(feats)}, beam_size=beam)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("head_kernel", [True, 4, False, None])
def test_pipeline_keeps_the_int(head_kernel):
    vocab = make_vocab()
    config = ConfigNode({"MODEL": model_config(d_feature=D_FEATURE).to_dict(),
                         "TRAINING": {"EVALUATING_BEAM_SIZE": 3, "DECODE_HEAD_KERNEL": 3}})
    pipe = CaptioningPipeline.from_state_dict(config, vocab, head_kernel=head_kernel,
                                              batch_size=2, device="cpu")
    want = 3 if head_kernel is None else head_kernel  # None: the config's value
    assert pipe.searcher.head_kernel is want


# ------------------------------------------------------------------ 2. k up to 128
@pytest.mark.parametrize("k", [17, 32, 128])
def test_plain_head_topk_matches_jax_above_16(k):
    """Values within one bf16 ulp, lse within 1e-4, ids equal (small-integer
    inputs: every product and f32 sum is exact, so ties resolve the same)."""
    rng = np.random.default_rng(k)
    x = (rng.integers(-8, 9, size=(12, 32)) / 8).astype(np.float32)
    w = (rng.integers(-8, 9, size=(32, 600)) / 64).astype(np.float32)  # JAX (D, V)
    jv, ji, jl = (np.asarray(a) for a in jax_head_topk(jnp.asarray(x), jnp.asarray(w), k=k,
                                                         tile=256))
    launches = head_ops.head_topk.launches
    pv, pi, pl = (a.numpy() for a in head_ops.head_topk(
        torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T)), k))
    assert head_ops.head_topk.launches == launches
    assert pv.shape == pi.shape == (12, k)
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pl, jl, atol=1e-4, rtol=0)


def test_operand_check_takes_k_up_to_128():
    bf = torch.bfloat16
    x, w = torch.zeros(4, 16, dtype=bf), torch.zeros(300, 16, dtype=bf)
    for k in (1, 16, 17, 64, 128):
        head_ops._check_operands(x, w, k)
    for k, weight in ((0, w), (129, w), (101, torch.zeros(100, 16, dtype=bf))):
        with pytest.raises(ValueError, match="1 <= k <= min"):
            head_ops._check_operands(x, weight, k)
    assert head_ops.MAX_K == 128


# ------------------------------------------------------------------ 3. bf16 decode
# Measured on this test's model and captions (CPU, these seeds): JAX's own
# resident kernel against JAX's eager step differs by at most 0.0154 per
# step (the bar); the port's eager bf16 step against JAX's eager bf16 step
# by at most 0.0295 (mean 0.0058; 0.0296, mean 0.0077, before the port's
# residual sums and LayerNorms moved to f32).  The port is pinned at its
# measured bound.  The second witness below shows where the gap comes from:
# with XLA's CPU excess precision off (every bf16 op rounded to bf16), JAX's
# own kernel and eager step differ by 0.0303, and the port sits inside it.
BF16_JAX_BAR = 0.0154
BF16_PORT_MAX = 0.0300
BF16_PORT_MEAN = 0.0065
BF16_JAX_STRICT_BAR = 0.0303
STRICT_XLA_FLAG = "--xla_allow_excess_precision=false"


def _jax_forced(jax_model, jax_params, vocab, feats, tokens, ids):
    """Per-step bf16 log-probs of the forced tokens through the JAX eager
    step and the JAX resident kernel (beam-resident step, beam 1)."""
    bs, L = ids.shape
    bf = jnp.bfloat16
    params = jax.tree.map(lambda a: a.astype(bf), jax_params)

    @functools.partial(jax.jit, static_argnames="resident")
    def run(params, feats, tokens, resident):
        memory, mask = jax_model.apply(params, {"region_features": feats},
                                       method=jax_model.encoder_forward)
        cache = jax_make_decode_cache(jax_model.config.DECODER, vocab, bs)
        cache = jax.tree.map(lambda a: a.astype(bf) if a.dtype == jnp.float32 else a, cache)
        cache = jax_model.apply(params, cache, memory, method=jax_model.prepare_cache)
        ancestry = jnp.zeros((bs, 1, L), jnp.int32)
        out = []
        for t in range(L):
            log_probs, cache = jax_model.apply(
                params, t, tokens[:, t : t + 1], cache, mask, ancestry=ancestry, beam_select=1,
                resident_kernel=resident, method=jax_model.decode_step)
            out.append(log_probs)
        return jnp.stack(out, axis=1)

    def forced(log_probs):
        return np.take_along_axis(np.asarray(log_probs, np.float32), ids[..., None], 2)[..., 0]

    jfeats, jtokens = jnp.asarray(feats, bf), jnp.asarray(tokens)
    return (forced(run(params, jfeats, jtokens, resident=False)),
            forced(run(params, jfeats, jtokens, resident=True)))


@functools.lru_cache(maxsize=None)
def _forced_decodes(seed: int):
    """The JAX package's bf16 beam decode (beam 3) of 8 images gives the
    captions; they are fed back one step at a time through the JAX eager
    step, the JAX resident kernel and the port's eager step, all bf16.
    Returns the captions' ids, the decoder inputs, the scored steps (up to
    the first <eos>) and the three per-step log-probs of the forced tokens."""
    vocab = make_vocab()
    jax_model, jax_params, port_model = make_pair(vocab, seed=seed, eos_gain=0.5)
    bs, L = 8, vocab.max_caption_length
    feats = make_features(bs, seed=11)
    ids = np.asarray(jax_beam_search(jax_model, jax_params, {"region_features": jnp.asarray(feats)},
                                     beam_size=3, compute_dtype=jnp.bfloat16)[0]).reshape(bs, L)
    tokens = np.concatenate([np.full((bs, 1), vocab.bos_idx), ids[:, :-1]], axis=1)
    is_eos = (ids == vocab.eos_idx).astype(int)
    scored = (np.cumsum(is_eos, axis=1) - is_eos) == 0  # steps up to the first <eos>
    jax_eager, jax_kernel = _jax_forced(jax_model, jax_params, vocab, feats, tokens, ids)

    model = port_model.to(torch.bfloat16)
    with torch.no_grad():
        memory, mask = model.encoder_forward(
            {"region_features": torch.from_numpy(feats).bfloat16()})
        cache = model.prepare_cache(
            make_decode_cache(model.config.DECODER, vocab, bs, dtype=torch.bfloat16), memory)
        ancestry = torch.zeros((bs, 1, L), dtype=torch.long)
        steps = []
        for t in range(L):
            log_probs, cache = model.decode_step(
                t, torch.from_numpy(tokens[:, t : t + 1]).long(), cache, mask,
                ancestry=ancestry, beam_select=1)
            steps.append(log_probs)
    port = np.take_along_axis(torch.stack(steps, dim=1).float().numpy(), ids[..., None], 2)[..., 0]
    return dict(feats=feats, ids=ids, tokens=tokens, scored=scored, jax_eager=jax_eager,
                jax_kernel=jax_kernel, port=port)


def _strict_jax_forced(path: str, seed: int) -> None:
    """Run in a fresh process whose XLA_FLAGS hold STRICT_XLA_FLAG: JAX's
    forced decodes of the captions in ``path`` (written back there)."""
    data = dict(np.load(path))
    vocab = make_vocab()
    jax_model, jax_params, _ = make_pair(vocab, seed=seed, eos_gain=0.5)
    eager, kernel = _jax_forced(jax_model, jax_params, vocab, data["feats"], data["tokens"],
                                data["ids"])
    np.savez(path, **data, strict_eager=eager, strict_kernel=kernel)


@pytest.mark.parametrize("seed", [3])
def test_bf16_forced_decode_against_jax(seed):
    """The forced decode of ``_forced_decodes``: per-step log-probs of the
    forced tokens compared (a forced decode: near-ties cannot change the
    path)."""
    f = _forced_decodes(seed)
    scored = f["scored"]
    assert scored.sum() >= 48  # long captions: the gaps are taken over many steps
    bar = np.abs(f["jax_kernel"] - f["jax_eager"])[scored].max()
    gap = np.abs(f["port"] - f["jax_eager"])[scored]
    msg = f"JAX kernel vs eager {bar:.4f}; port vs JAX max {gap.max():.4f}, mean {gap.mean():.4f}"
    assert bar == pytest.approx(BF16_JAX_BAR, abs=5e-4), msg
    assert gap.max() <= BF16_PORT_MAX and gap.mean() <= BF16_PORT_MEAN, msg
    # tokens decoded by the port at bf16 are valid and its log-probs finite
    vocab = make_vocab()
    _, _, port_model = make_pair(vocab, seed=seed, eos_gain=0.5)
    got, lps = port_beam_search(port_model, {"region_features": torch.from_numpy(f["feats"])},
                                beam_size=3, compute_dtype=torch.bfloat16)
    assert got.max() < len(vocab) and torch.isfinite(lps).all()


@pytest.mark.parametrize("seed", [3])
def test_bf16_gap_is_xla_excess_precision(seed, tmp_path):
    """The second witness: the same captions forced through JAX in a fresh
    process with XLA's excess precision off (the flag is read when the
    backend starts).  JAX's kernel then differs from its own eager step by
    0.0303, and the port's gap to either JAX eager step stays inside that."""
    f = _forced_decodes(seed)
    path = tmp_path / "forced.npz"
    np.savez(path, feats=f["feats"], tokens=f["tokens"], ids=f["ids"])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {STRICT_XLA_FLAG}".strip())
    code = ("import sys; from tests.test_torch_port_repairs import _strict_jax_forced; "
            f"_strict_jax_forced(sys.argv[1], {seed})")
    done = subprocess.run([sys.executable, "-c", code, str(path)], cwd=REPO_ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    strict = np.load(path)
    scored = f["scored"]
    strict_bar = np.abs(strict["strict_kernel"] - strict["strict_eager"])[scored].max()
    to_default = np.abs(f["port"] - f["jax_eager"])[scored].max()
    to_strict = np.abs(f["port"] - strict["strict_eager"])[scored].max()
    msg = (f"strict JAX kernel vs eager {strict_bar:.4f}; port vs default eager "
           f"{to_default:.4f}, vs strict eager {to_strict:.4f}")
    assert strict_bar == pytest.approx(BF16_JAX_STRICT_BAR, abs=2e-3), msg
    assert to_default <= strict_bar and to_strict <= strict_bar, msg
