"""The port's SCST (``openviic_tpu_torch.training``: the device reward, the
SCST step, ``ScstSetup`` / ``scst_iteration``) and its dropout-active beam
sampling against the JAX package on the CPU, and the decode's
compute-dtype shadow.

Models are the flagship architecture at d_model 64, 4 heads, 2+2 layers
(tests/test_torch_port_training.py's), with the same weights in both
packages; the head's <eos> column copies a frequent word's, so that beams
end at different steps.  The port cannot draw JAX's dropout masks, so dropout sampling is
held to JAX at dropout 0 and by its statistics at 0.1
(tests/test_scst_dropout.py's patterns)."""

import copy
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from openviic_tpu.builders import build_model as build_jax_model
from openviic_tpu.config import ConfigNode as JaxConfigNode
from openviic_tpu.decoding import BeamSearcher as JaxBeamSearcher
from openviic_tpu.evaluation import Cider as JaxCider
from openviic_tpu.training import device_reward as jax_reward
from openviic_tpu.training import optim as jax_optim
from openviic_tpu.training import steps as jax_steps
from openviic_tpu_torch import native, rng
from openviic_tpu_torch.compat.from_jax import torch_name
from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.decoding import BeamSearcher, beam_search
from openviic_tpu_torch.evaluation import Cider
from openviic_tpu_torch.models import attention as attention_module
from openviic_tpu_torch.models import decoders as decoders_module
from openviic_tpu_torch.training import device_reward, optim, steps
from openviic_tpu_torch.training.trainer import SCST_SAMPLE_SALT, ScstSetup, scst_iteration
from tests.test_torch_port_support import make_vocab
from tests.test_torch_port_training import (
    D_FEATURE,
    _config,
    assert_grads_match,
    port_model,
)

BEAM = 3
BS = 4
REWARD_JAX_TOL = 1e-6  # the device reward against JAX's
REWARD_HOST_TOL = 1e-5  # against the host scorer (tests/test_device_reward.py's bar)
LP_TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each gradient leaf's max-abs
UPDATE_TOL = 1e-7
RL_LR = 5e-6
# <eos>'s head column copies that of a word the decode often picks, so that
# beams end at different steps
EOS_TWIN = 35


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """At these widths one torch thread is fastest, and keeps the file's
    cost steady beside other test processes on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    """The vocab, the JAX model and its flat parameters, drawn with numpy
    by test_torch_port_support.random_params's scheme over the shapes that
    ``jax.eval_shape`` gives (no initialiser runs), in sorted key order."""
    vocab = make_vocab(size=150, max_len=12)
    jax_model = build_jax_model(JaxConfigNode(_config()), vocab)
    batch = {"region_features": np.zeros((2, 7, D_FEATURE), np.float32),
             "caption_tokens": np.zeros((2, vocab.max_caption_length), np.int32)}
    shapes = traverse_util.flatten_dict(
        jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), batch), sep="/")
    rng = np.random.default_rng(0)
    flat = {}
    for key in sorted(shapes):
        shape = shapes[key].shape
        if key.endswith("scale"):
            value = 1.0 + 0.1 * rng.normal(size=shape)
        elif key.endswith("bias"):
            value = 0.1 * rng.normal(size=shape)
        else:
            value = rng.normal(size=shape) / np.sqrt(shape[0])
        flat[key] = value.astype(np.float32)
    head = flat["params/decoder/fc/kernel"]
    head[:, vocab.eos_idx] = head[:, EOS_TWIN]
    return vocab, jax_model, flat


def jax_params(flat):
    return traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def features(seed: int, bs: int = BS) -> np.ndarray:
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(bs, 7, D_FEATURE)).astype(np.float32)
    for i in range(bs):
        feats[i, 4 + i % 3:] = 0.0  # ragged regions
    return feats


def train_captions(vocab, n: int = 30, seed: int = 3):
    """Token lists of vocab words, with a few tokens outside the vocab."""
    rng = np.random.default_rng(seed)
    caps = []
    for i in range(n):
        words = [vocab.itos[j] for j in rng.integers(4, len(vocab), size=int(rng.integers(3, 9)))]
        if i % 7 == 0:
            words.append(f"rare{i % 2}")
        caps.append(words)
    return caps


def references(vocab, bs: int, seed: int):
    """Per image 1-3 reference strings, one with two out-of-vocab tokens."""
    rng = np.random.default_rng(seed)
    refs = []
    for b in range(bs):
        image = []
        for _ in range(int(rng.integers(1, 4))):
            n = int(rng.integers(2, 9))
            image.append(" ".join(vocab.itos[j] for j in rng.integers(4, 40, size=n)))
        refs.append(image)
    refs[0][0] += " zzz_rare zzz_rare"
    return refs


def sampled_rows(vocab, n: int, seed: int) -> np.ndarray:
    """tests/test_device_reward.py's rows: ragged ends at <eos> then <pad>,
    an empty caption and a special mid-caption."""
    rng = np.random.default_rng(seed)
    L = vocab.max_caption_length
    sampled = rng.integers(4, 40, size=(n, L)).astype(np.int32)
    for i in range(n):
        end = rng.integers(2, L - 1)
        sampled[i, end] = vocab.eos_idx
        sampled[i, end + 1:] = vocab.padding_idx
    sampled[0, 0] = vocab.eos_idx
    sampled[1, 1] = vocab.unk_idx
    return sampled


def host_reward(cider, vocab, sampled, refs_per_row):
    """What the trainer's host reward computes (string references)."""
    caps = vocab.decode_caption(np.asarray(sampled), join_words=True)
    gens = {str(i): [c] for i, c in enumerate(caps)}
    gts = {str(i): list(r) for i, r in enumerate(refs_per_row)}
    return cider.compute_score(gts, gens)[1]


# ------------------------------------------------------------ device reward
def test_device_cider_matches_jax_and_host(setup):
    """Token-list ground truths (OOV tokens included) against JAX's
    DeviceCider and the host scorer."""
    vocab = setup[0]
    train = train_captions(vocab)
    sampled = sampled_rows(vocab, 6, seed=0)
    gts = [train[i % len(train)] + (["zzz_rare"] if i % 2 else []) for i in range(6)]
    port = device_reward.DeviceCider(vocab, train, device="cpu")
    ref = jax_reward.DeviceCider(vocab, train)
    max_ref = max(len(g) for g in gts)
    ids, idf, valid = port.encode_refs(gts, max_ref)
    for got_a, want_a in zip((ids, idf, valid), ref.encode_refs(gts, max_ref)):
        np.testing.assert_array_equal(got_a, want_a)
    got = port.score(*(torch.from_numpy(a) for a in (sampled, ids, idf, valid))).numpy()
    want = np.asarray(jax.jit(ref.score)(*(jnp.asarray(a) for a in (sampled, ids, idf, valid))))
    np.testing.assert_allclose(got, want, rtol=0, atol=REWARD_JAX_TOL)
    cider = Cider({str(i): c for i, c in enumerate(train)})
    expected = host_reward(cider, vocab, sampled, gts)
    np.testing.assert_allclose(got, expected, rtol=0, atol=REWARD_HOST_TOL)


def test_device_cider_full_matches_jax_and_host_reward(setup):
    """Caption-string references with OOV tokens and ragged counts, a row
    that copies a reference, against JAX's DeviceCiderFull and the
    trainer's host reward: the port's Python Cider, its native CIDEr with
    the train df, and the JAX package's Cider."""
    vocab = setup[0]
    train = train_captions(vocab)
    refs = references(vocab, 3, seed=7)
    sampled = sampled_rows(vocab, 3 * BEAM, seed=1)
    copy_row = [vocab.stoi[t] for t in refs[1][0].split()] + [vocab.eos_idx]
    sampled[3] = (copy_row + [vocab.padding_idx] * 12)[:12]
    port = device_reward.DeviceCiderFull(vocab, train, device="cpu")
    ref = jax_reward.DeviceCiderFull(vocab, train)
    n_ref = max(len(r) for r in refs)
    r_max = max(len(c.split()) for r in refs for c in r)
    arrays = port.encode_refs(refs, n_ref, r_max)
    for got_a, want_a in zip(arrays, ref.encode_refs(refs, n_ref, r_max)):
        np.testing.assert_array_equal(got_a, want_a)
    on_device = port.encode_refs_on_device(refs)
    for got_t, want_a in zip(on_device, arrays):
        np.testing.assert_array_equal(got_t.numpy(), want_a)
    got = port.score(torch.from_numpy(sampled), *on_device, beam_size=BEAM).numpy()
    want = np.asarray(jax.jit(ref.score, static_argnames=("beam_size",))(
        jnp.asarray(sampled), *(jnp.asarray(a) for a in arrays), beam_size=BEAM))
    np.testing.assert_allclose(got, want, rtol=0, atol=REWARD_JAX_TOL)
    rows = [refs[i // BEAM] for i in range(len(sampled))]
    train_gts = {str(i): c for i, c in enumerate(train)}
    hosts = [Cider(train_gts), JaxCider(train_gts)]
    if native.available():
        hosts.append(native.NativeCider(gts=train_gts))
    for cider in hosts:
        expected = host_reward(cider, vocab, sampled, rows)
        np.testing.assert_allclose(got, expected, rtol=0, atol=REWARD_HOST_TOL)
    assert got[3] > 1.0  # the copied reference scores high


# --------------------------------------------------------------- SCST step
@pytest.fixture(scope="module")
def jax_fns(setup):
    """The JAX package's functions of these tests, each jitted once."""
    vocab, jax_model, flat = setup

    def log_probs(p, feats, sampled):
        batch = {"region_features": jnp.repeat(feats, BEAM, axis=0)}
        return jax_steps.scst_log_probs(jax_model, p, batch, sampled, rng=jax.random.PRNGKey(0))

    return {
        "searcher": JaxBeamSearcher(jax_model),
        "log_probs": jax.jit(log_probs),
        "step": jax_steps.make_scst_grad_step(
            jax_model, jax_optim.mask_frozen(jax_optim.make_rl_optimizer(RL_LR),
                                             jax_params(flat)), BEAM),
    }


def jax_scst_state(flat):
    opt = jax_optim.make_rl_optimizer(RL_LR)
    return {"params": jax_params(flat), "opt_state": opt.init(jax_params(flat)), "step": 0,
            "rng": jax.random.PRNGKey(0)}


@pytest.fixture(scope="module")
def beams(setup, jax_fns):
    """Beams sampled by the JAX package (f32, no dropout), a stubbed reward
    and the unexpanded batch."""
    vocab, jax_model, flat = setup
    feats = features(seed=0)
    outs, _ = jax_fns["searcher"](jax_params(flat), {"region_features": jnp.asarray(feats)},
                                  beam_size=BEAM, out_size=BEAM)
    sampled = np.array(outs).reshape(BS * BEAM, -1)
    ended = (sampled[:, :-1] == vocab.eos_idx).any(axis=1)
    assert ended.any() and not ended.all()  # ragged ends
    reward = np.random.default_rng(4).uniform(0, 2, size=(BS, BEAM)).astype(np.float32)
    return feats, sampled, reward


@pytest.fixture(scope="module")
def jax_scst(setup, jax_fns, beams):
    """One JAX make_scst_grad_step on ``beams`` (dropout 0): its loss, the
    log-probs, the gradients and the updated parameters (flat).  The
    gradients are read from the step's first Adam moment, which after one
    update from zero is (1 - b1) g: one f32 rounding off g."""
    flat = setup[2]
    feats, sampled, reward = (jnp.asarray(a) for a in beams)
    state, loss = jax_fns["step"](jax_scst_state(flat), {"region_features": feats}, sampled,
                                  reward)
    lp = jax_fns["log_probs"](jax_params(flat), feats, sampled)
    adam = state["opt_state"][0]  # optax.adam: (scale_by_adam's state, the lr's)
    assert int(adam.count) == 1
    grads = jax.tree_util.tree_map(lambda mu: mu / (1 - 0.9), adam.mu)

    def flatten(tree):
        return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}
    return float(loss), np.asarray(lp), flatten(grads), flatten(state["params"])


def test_scst_log_probs_match_jax(setup, beams, jax_scst):
    vocab, _, flat = setup
    feats, sampled, _ = beams
    want = jax_scst[1]
    model = port_model(vocab, flat)
    rows = {"region_features": torch.from_numpy(feats).repeat_interleave(BEAM, 0)}
    with torch.no_grad():
        got = steps.scst_log_probs(model, rows, torch.from_numpy(sampled)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LP_TOL)
    # strictly after the first <eos> every position contributes 0, whatever
    # tokens lie there; the eos step keeps its log-prob
    is_eos = sampled == vocab.eos_idx
    after = (np.cumsum(is_eos, axis=1) - is_eos) > 0
    assert after.any() and (got[after] == 0).all() and (got[is_eos & ~after] != 0).all()
    garbage = np.where(after, np.random.default_rng(0).integers(4, 150, sampled.shape), sampled)
    with torch.no_grad():
        again = steps.scst_log_probs(model, rows, torch.from_numpy(garbage)).numpy()
    np.testing.assert_array_equal(again, got)


def test_scst_step_matches_jax_loss_gradients_and_update(setup, beams, jax_scst):
    vocab, _, flat = setup
    feats, sampled, reward = beams
    want_loss, _, want, new = jax_scst

    model = port_model(vocab, flat)
    state = steps.init_xe_state(model, optim.make_rl_optimizer(optim.mask_frozen(model), RL_LR))
    state, loss = steps.make_scst_grad_step(model, BEAM)(
        state, {"region_features": torch.from_numpy(feats)}, torch.from_numpy(sampled),
        torch.from_numpy(reward))
    assert state["step"] == 1 and not model.training
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert_grads_match(model, want, GRAD_TOL, flat)

    # one Adam update: the first step moves each weight by about +-lr, so a
    # gradient at rounding level flips a weight's direction; compare where
    # JAX's gradient is above GRAD_TOL of its leaf's max-abs (of the largest
    # gradient for the key projections' biases, whose gradient is zero but
    # for rounding, as assert_grads_match scales them)
    named = dict(model.named_parameters())
    largest = max(float(np.abs(g).max()) for g in want.values())
    compared = 0
    for key, grad in want.items():
        name, transpose = torch_name(key)
        got_p = named[name].detach().numpy()
        want_p = np.asarray(new[key]).T if transpose else np.asarray(new[key])
        g = grad.T if transpose else grad
        scale = largest if key.endswith("fc_k/bias") else np.abs(g).max()
        firm = np.abs(g) > GRAD_TOL * scale
        compared += int(firm.sum())
        np.testing.assert_allclose(got_p[firm], want_p[firm], rtol=0, atol=UPDATE_TOL,
                                   err_msg=key)
    assert compared > 0.5 * sum(g.size for g in want.values())  # 89% here


def test_scst_step_refuses_under_pallas(setup, beams, monkeypatch):
    """The fused attention kernel has no backward, as JAX's grad refuses its
    Pallas kernel: the step raises under OPENVIIC_PALLAS=1."""
    vocab, _, flat = setup
    feats, sampled, reward = beams
    model = port_model(vocab, flat)
    state = steps.init_xe_state(model, optim.make_rl_optimizer(model.parameters(), RL_LR))
    monkeypatch.setenv("OPENVIIC_PALLAS", "1")
    with pytest.raises(RuntimeError, match="no backward"):
        steps.make_scst_grad_step(model, BEAM)(
            state, {"region_features": torch.from_numpy(feats)}, torch.from_numpy(sampled),
            torch.from_numpy(reward))


# ------------------------------------------------------ dropout sampling
def test_dropout_sampling_at_rate_zero_equals_jax_and_the_plain_decode(setup, jax_fns):
    vocab, _, flat = setup
    feats = features(seed=5)
    want, _ = jax_fns["searcher"](jax_params(flat), {"region_features": jnp.asarray(feats)},
                                  beam_size=BEAM, out_size=BEAM,
                                  dropout_rng=jax.random.PRNGKey(3))
    model = port_model(vocab, flat)
    batch = {"region_features": torch.from_numpy(feats)}
    got, got_lp = beam_search(model, batch, BEAM, out_size=BEAM, train_dropout_rng=3)
    plain, plain_lp = beam_search(model, batch, BEAM, out_size=BEAM)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).reshape(got.shape))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    torch.testing.assert_close(got_lp, plain_lp, rtol=0, atol=0)


@pytest.fixture(scope="module")
def dropout_model(setup):
    vocab, _, flat = setup
    return port_model(vocab, flat, dropout=0.1)


def test_dropout_sampling_is_seeded_and_leaves_the_global_rng(dropout_model):
    model = dropout_model
    batch = {"region_features": torch.from_numpy(features(seed=6))}
    cpu_state = torch.get_rng_state()
    out_a, lp_a = beam_search(model, batch, BEAM, out_size=BEAM, train_dropout_rng=1)
    assert torch.equal(torch.get_rng_state(), cpu_state)
    assert not model.training
    out_a2, lp_a2 = beam_search(model, batch, BEAM, out_size=BEAM,
                                train_dropout_rng=torch.Generator().manual_seed(9))
    out_b, lp_b = beam_search(model, batch, BEAM, out_size=BEAM,
                              train_dropout_rng=torch.Generator().manual_seed(9))
    out_c, lp_c = beam_search(model, batch, BEAM, out_size=BEAM, train_dropout_rng=1)
    _, lp_det = beam_search(model, batch, BEAM, out_size=BEAM)
    assert torch.equal(out_a, out_c) and torch.equal(lp_a, lp_c)
    assert torch.equal(out_a2, out_b) and torch.equal(lp_a2, lp_b)
    assert torch.isfinite(lp_a).all()
    # dropout acts at every site, so the scores move off the deterministic
    # decode's and between seeds
    assert not torch.allclose(lp_a, lp_det)
    assert not torch.allclose(lp_a, lp_a2)
    assert torch.equal(torch.get_rng_state(), cpu_state)


def test_every_dropout_site_drops_its_share(dropout_model):
    """Forward hooks on every nn.Dropout: each site is active in the
    sampling decode (encoder and steps) and zeroes a share of its nonzero
    inputs within 5 sigma of the rate."""
    model = dropout_model
    seen = {}

    def hook(name):
        def record(module, inputs, output):
            live = inputs[0] != 0
            dropped, total = seen.get(name, (0, 0))
            seen[name] = (dropped + int((output[live] == 0).sum()), total + int(live.sum()))
        return record

    sites = [(n, m) for n, m in model.named_modules() if isinstance(m, torch.nn.Dropout)]
    handles = [m.register_forward_hook(hook(n)) for n, m in sites]
    try:
        beam_search(model, {"region_features": torch.from_numpy(features(seed=8, bs=8))}, BEAM,
                    out_size=BEAM, train_dropout_rng=11)
    finally:
        for h in handles:
            h.remove()
    assert set(seen) == {n for n, _ in sites} and len(sites) >= 15
    for name, (dropped, total) in seen.items():
        sigma = np.sqrt(0.1 * 0.9 / total)
        assert abs(dropped / total - 0.1) <= 5 * sigma, (name, dropped, total)


def _counting(monkeypatch, module, name):
    calls = []
    wrapped = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return wrapped(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_dropout_sampling_bypasses_the_layer_kernels(dropout_model, monkeypatch):
    """Under dropout the whole-layer kernels are never called (they do not
    implement dropout), while the head kernel and the beam-select attention
    kernel run (their plain versions here) at every step."""
    # the module, not the function the package exports under its name
    beam_search_module = importlib.import_module("openviic_tpu_torch.decoding.beam_search")
    model = dropout_model
    batch = {"region_features": torch.from_numpy(features(seed=9))}
    n_layers = len(model.decoder.layers)
    resident = _counting(monkeypatch, decoders_module, "resident_layer_step")
    fused = _counting(monkeypatch, decoders_module, "fused_layer_step")
    head = _counting(monkeypatch, beam_search_module, "head_topk")
    select = _counting(monkeypatch, attention_module, "beam_select_attention")

    searcher = BeamSearcher(model, head_kernel=1, resident_kernel=True)
    searcher(batch, BEAM, out_size=BEAM)  # eval mode: the resident kernel runs
    assert len(resident) == n_layers * searcher.steps > 0
    resident.clear(), head.clear()
    steps0 = searcher.steps
    searcher(batch, BEAM, out_size=BEAM, dropout_rng=2)
    assert not resident and len(head) == searcher.steps - steps0 > 0

    both = BeamSearcher(model, head_kernel=1, attn_kernel=True, resident_kernel=True)
    both(batch, BEAM, out_size=BEAM, dropout_rng=2)
    assert not resident and len(select) == n_layers * both.steps > 0

    monkeypatch.setenv("OPENVIIC_FUSED_STEP", "1")
    non_resident = BeamSearcher(model, beam_resident=False)
    non_resident(batch, BEAM, out_size=BEAM)
    assert len(fused) == n_layers * non_resident.steps > 0
    fused.clear()
    non_resident(batch, BEAM, out_size=BEAM, dropout_rng=2)
    assert not fused
    with pytest.raises(NotImplementedError):
        searcher(batch, BEAM, language_table=torch.zeros(3))


# -------------------------------------------------- compute-dtype shadow
def test_bf16_shadow_follows_every_update(setup):
    """The searcher's bf16 copy is cast once, reused while the weights
    stand still, and refreshed after an optimizer step or a
    load_state_dict: its decode equals a fresh cast's."""
    vocab, _, flat = setup
    model = port_model(vocab, flat)
    batch = {"region_features": torch.from_numpy(features(seed=10))}
    searcher = BeamSearcher(model, compute_dtype=torch.bfloat16)

    def fresh_decode():
        return beam_search(copy.deepcopy(model).to(torch.bfloat16), batch, BEAM, out_size=BEAM)

    first = searcher(batch, BEAM, out_size=BEAM)
    again = searcher(batch, BEAM, out_size=BEAM)
    assert searcher.shadow.casts == 1
    assert next(model.parameters()).dtype == torch.float32
    for got, want in zip(again, first):
        assert torch.equal(got, want)

    opt = torch.optim.Adam(model.parameters(), lr=0.05)  # the RL optimizer's kind
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    after = searcher(batch, BEAM, out_size=BEAM)
    assert searcher.shadow.casts == 2
    for got, want in zip(after, fresh_decode()):
        assert torch.equal(got, want)
    assert not torch.equal(after[1], first[1])  # the update shows in the scores

    model.load_state_dict(port_model(vocab, flat).state_dict())
    restored = searcher(batch, BEAM, out_size=BEAM)
    assert searcher.shadow.casts == 3
    for got, want in zip(restored, first):
        assert torch.equal(got, want)


# ------------------------------------------------------- the slice whole
def test_scst_iteration_matches_the_jax_stages(setup, jax_fns):
    """One scst_iteration (f32 sampling, device reward, the step) against
    the JAX package's BeamSearcher, DeviceCiderFull and make_scst_grad_step
    on the same weights and batch."""
    vocab, _, flat = setup
    feats = features(seed=12)
    refs = references(vocab, BS, seed=13)
    train = train_captions(vocab)

    jbatch = {"region_features": jnp.asarray(feats)}
    jouts, _ = jax_fns["searcher"](jax_params(flat), jbatch, beam_size=BEAM, out_size=BEAM)
    jsampled = jnp.asarray(jouts).reshape(BS * BEAM, -1)
    jdev = jax_reward.DeviceCiderFull(vocab, train)
    n_ref = max(len(r) for r in refs)
    r_max = max(len(c.split()) for r in refs for c in r)
    jreward = jax.jit(jdev.score, static_argnames=("beam_size",))(
        jsampled, *(jnp.asarray(a) for a in jdev.encode_refs(refs, n_ref, r_max)),
        beam_size=BEAM).reshape(BS, BEAM)
    _, jloss = jax_fns["step"](jax_scst_state(flat), jbatch, jsampled, jreward)

    model = port_model(vocab, flat)
    training = ConfigNode({"RL_LEARNING_RATE": RL_LR, "TRAINING_BEAM_SIZE": BEAM})
    scst = ScstSetup(model, steps.init_xe_state(model, None), train, training)
    assert isinstance(scst.device_reward, device_reward.DeviceCiderFull)
    sampled = []
    searcher = scst.searcher
    scst.searcher = lambda *a, **k: sampled.append(searcher(*a, **k)) or sampled[-1]
    stages = []
    loss, mean_reward = scst_iteration(scst, {"region_features": torch.from_numpy(feats)}, refs,
                                       marks=stages.append)
    assert stages == ["sample", "reward", "step"] and scst.state["step"] == 1
    outs = sampled[0][0]
    np.testing.assert_array_equal(outs.numpy(), np.asarray(jouts).reshape(outs.shape))
    assert abs(float(mean_reward) - float(jreward.mean())) <= REWARD_JAX_TOL
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))

    # the host reward (no device reward) gives the same iteration
    host_model = port_model(vocab, flat)
    host = ScstSetup(host_model, steps.init_xe_state(host_model, None), train,
                     ConfigNode(dict(training.to_dict(), DEVICE_REWARD=False)))
    assert host.device_reward is None
    host_loss, host_reward_mean = scst_iteration(
        host, {"region_features": torch.from_numpy(feats)}, refs)
    assert abs(float(host_reward_mean) - float(mean_reward)) <= REWARD_HOST_TOL
    assert abs(float(host_loss) - float(loss)) <= 1e-4 * abs(float(loss))


def test_scst_iteration_samples_dropout_from_the_state_seed(setup):
    """With SCST_SAMPLE_DROPOUT the sample's seed comes from the state's
    generator without advancing it (only the step draws), so the same
    state gives the same samples, and another state other samples."""
    vocab, _, flat = setup
    feats = {"region_features": torch.from_numpy(features(seed=14))}
    refs = references(vocab, BS, seed=15)
    training = ConfigNode({"RL_LEARNING_RATE": RL_LR, "TRAINING_BEAM_SIZE": BEAM,
                           "SCST_SAMPLE_DROPOUT": True})

    def run(seed):
        model = port_model(vocab, flat, dropout=0.1)
        scst = ScstSetup(model, steps.init_xe_state(model, None, seed=seed),
                         train_captions(vocab), training)
        searched = []
        searcher = scst.searcher
        scst.searcher = lambda *a, **k: searched.append((searcher(*a, **k), k)) or searched[-1][0]
        scst_iteration(scst, feats, refs)
        (outs, _), kwargs = searched[0]
        return outs, kwargs["dropout_rng"], scst.state["generator"]

    outs_a, seed_a, gen_a = run(0)
    outs_b, seed_b, _ = run(0)
    outs_c, seed_c, _ = run(1)
    fresh = torch.Generator().manual_seed(0)
    assert seed_a == seed_b != seed_c
    assert seed_a == rng.fold_in(rng.peek_seed(fresh), SCST_SAMPLE_SALT)
    rng.draw_seed(fresh)  # the step's one draw
    assert torch.equal(gen_a.get_state(), fresh.get_state())
    assert torch.equal(outs_a, outs_b) and not torch.equal(outs_a, outs_c)
