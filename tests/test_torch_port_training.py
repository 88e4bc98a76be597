"""The port's XE training (``openviic_tpu_torch.training``) against the JAX
package's ``training/steps.py`` and ``training/optim.py`` on the CPU.

Both models are the flagship architecture at d_model 64, 4 heads, 2+2
layers, d_ff 128, with dropout 0 and the same weights (drawn with numpy
in the JAX layout, carried through ``compat/from_jax.py``).  Gradients
compare through the same names and transposes as that carry."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from openviic_tpu.builders import build_model as build_jax_model
from openviic_tpu.config import ConfigNode as JaxConfigNode
from openviic_tpu.training import optim as jax_optim
from openviic_tpu.training import steps as jax_steps
from openviic_tpu_torch.artifact import artifact_config
from openviic_tpu_torch.builders import build_model as build_port_model
from openviic_tpu_torch.compat.from_jax import load_jax_params, torch_name
from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.training import optim, steps
from tests.test_torch_port_support import make_vocab, random_params

D_FEATURE = 24
BS = 6
WARMUP = 40
LOSS_RTOL = 1e-5  # one f32 step's loss
GRAD_TOL = 1e-4  # every gradient leaf, of its max-abs
SEQ_RTOL = 2e-3  # a 20-step loss sequence: the JAX package's own bar


def _config(dropout: float = 0.0) -> dict:
    def walk(node):
        if isinstance(node, dict):
            return {k: (dropout if k == "DROPOUT" else walk(v)) for k, v in node.items()}
        return node

    model = artifact_config(d_model=64, heads=4, layers=2, d_ff=128).MODEL.to_dict()
    model["VISION_EMBEDDING"]["D_FEATURE"] = D_FEATURE
    return walk(model)


@pytest.fixture(scope="module")
def setup():
    vocab = make_vocab(size=150, max_len=12)
    jax_model = build_jax_model(JaxConfigNode(_config()), vocab)
    flat = random_params(jax_model, vocab, seed=0)
    # random_params draws its template at d_feature 13: redraw the feature projection
    rng = np.random.default_rng(1)
    flat["params/vision_embedding/proj/kernel"] = (
        rng.normal(size=(D_FEATURE, 64)) / np.sqrt(D_FEATURE)).astype(np.float32)
    return vocab, jax_model, flat


def make_batch(vocab, seed: int, bs: int = BS, ragged: bool = True):
    """Teacher-forcing batch: ragged regions (zero rows) and captions of
    ragged length, built as the datasets build one instance."""
    rng = np.random.default_rng(seed)
    L = vocab.max_caption_length
    feats = rng.normal(size=(bs, 7, D_FEATURE)).astype(np.float32)
    tokens = np.full((bs, L), vocab.padding_idx, np.int32)
    target = np.full((bs, L), vocab.padding_idx, np.int32)
    for i in range(bs):
        if ragged:
            feats[i, 3 + i % 4:] = 0.0
        n = 2 + (i * 3) % (L - 2) if ragged else L - 2
        words = rng.integers(4, len(vocab), size=n)
        enc = np.concatenate([[vocab.bos_idx], words, [vocab.eos_idx]])
        tokens[i, : n + 1] = enc[:-1]
        target[i, : n + 1] = enc[1:]
    return {"region_features": feats, "caption_tokens": tokens,
            "shifted_right_caption_tokens": target}


def port_model(vocab, flat, dropout: float = 0.0):
    model = build_port_model(ConfigNode(_config(dropout)), vocab, device="cpu")
    return load_jax_params(model, flat)


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_state(flat, optimizer):
    params = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    return {"params": params, "opt_state": optimizer.init(params), "step": 0,
            "rng": jax.random.PRNGKey(0)}


def port_state(model, d_model=64, warmup=WARMUP, seed=0):
    optimizer, scheduler = optim.make_optimizer(model.parameters(), d_model, warmup)
    return steps.init_xe_state(model, optimizer, scheduler, seed=seed)


def jax_grads(jax_model, flat, batch, mixed=False):
    params = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    pad = jax_model.vocab.padding_idx

    def loss_fn(p):
        mb = batch
        if mixed:
            p = jax_steps._cast_floating(p, jnp.bfloat16)
            mb = jax_steps._cast_floating(batch, jnp.bfloat16)
        logits = jax_model.apply(p, mb, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                                 raw_logits=True)
        return jax_steps.fused_nll(logits, batch["shifted_right_caption_tokens"], pad)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), {k: np.asarray(v) for k, v in
                         traverse_util.flatten_dict(grads, sep="/").items()}


def assert_grads_match(model, want, tol, flat_keys):
    """Every gradient leaf within ``tol`` of its max-abs.  The key
    projections' biases have a gradient that is zero but for rounding (the
    softmax ignores a shift common to all keys): they are held to ``tol``
    of the largest gradient.  Returns {key: error}."""
    named = dict(model.named_parameters())
    largest = max(float(np.abs(g).max()) for g in want.values())
    errors = {}
    for key in flat_keys:
        name, transpose = torch_name(key)
        got = named[name].grad.numpy()
        ref = want[key].T if transpose else want[key]
        if key.endswith("fc_k/bias"):
            scale = largest
        else:
            scale = float(np.abs(ref).max())
        err = float(np.abs(got - ref).max()) / scale
        errors[key] = err
    print({k: f"{v:.2e}" for k, v in sorted(errors.items(), key=lambda kv: -kv[1])[:8]})
    for key, err in errors.items():
        assert err <= tol, f"{key}: {err:.3g} of its max-abs"
    return errors


def test_one_xe_step_matches_jax_loss_and_gradients(setup):
    vocab, jax_model, flat = setup
    batch = make_batch(vocab, seed=0)
    want_loss, want = jax_grads(jax_model, flat, {k: jnp.asarray(v) for k, v in batch.items()})
    jstep = jax_steps.make_xe_step(jax_model, jax_optim.make_optimizer(64, WARMUP))
    _, jloss = jstep(jax_state(flat, jax_optim.make_optimizer(64, WARMUP)),
                     {k: jnp.asarray(v) for k, v in batch.items()})
    model = port_model(vocab, flat)
    state = port_state(model)
    state, loss = steps.make_xe_step(model)(state, torch_batch(batch))
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert state["step"] == 1
    assert_grads_match(model, want, GRAD_TOL, flat)


def test_twenty_xe_steps_match_jax(setup):
    vocab, jax_model, flat = setup
    batches = [make_batch(vocab, seed=s) for s in range(4)]
    jopt = jax_optim.make_optimizer(64, WARMUP)
    jstep = jax_steps.make_xe_step(jax_model, jopt)
    jstate = jax_state(flat, jopt)
    model = port_model(vocab, flat)
    state = port_state(model)
    step = steps.make_xe_step(model)
    jlosses, losses = [], []
    for i in range(20):
        b = batches[i % 4]
        jstate, jl = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, loss = step(state, torch_batch(b))
        jlosses.append(float(jl))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=SEQ_RTOL, atol=0)
    assert losses[-1] < losses[0]


def test_grad_accum_equals_full_batch(setup):
    """Token-weighted microbatches give the full batch's loss and update:
    within 1e-5 relative (loss) and 2e-5 (parameters), the bars of
    tests/test_grad_accum.py, under SGD so a delta is lr * grad."""
    vocab, _, flat = setup
    batch = torch_batch(make_batch(vocab, seed=5, bs=8))
    results = []
    for accum in (1, 2, 4):
        model = port_model(vocab, flat)
        state = steps.init_xe_state(model, torch.optim.SGD(model.parameters(), lr=0.1))
        state, loss = steps.make_xe_step(model, grad_accum=accum)(state, batch)
        results.append((float(loss), [p.detach().clone() for p in model.parameters()]))
    for loss, params in results[1:]:
        assert np.isclose(loss, results[0][0], rtol=1e-5)
        for a, b in zip(params, results[0][1]):
            torch.testing.assert_close(a, b, atol=2e-5, rtol=0)
    model = port_model(vocab, flat)
    state = steps.init_xe_state(model, torch.optim.SGD(model.parameters(), lr=0.1))
    with pytest.raises(ValueError, match="grad_accum"):
        steps.make_xe_step(model, grad_accum=3)(state, batch)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_multi_step_equals_single_steps(setup, dropout):
    """k updates in one call are bit-identical to k single steps from the
    same state and generator, dropout on or off."""
    vocab, _, flat = setup
    batches = [torch_batch(make_batch(vocab, seed=s)) for s in range(4)]
    runs = []
    for multi in (False, True):
        model = port_model(vocab, flat, dropout=dropout)
        state = port_state(model, seed=7)
        if multi:
            state, losses = steps.make_xe_multi_step(model)(state, batches)
        else:
            step = steps.make_xe_step(model)
            out = []
            for b in batches:
                state, loss = step(state, b)
                out.append(loss)
            losses = torch.stack(out)
        runs.append((losses, [p.detach().clone() for p in model.parameters()], state))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
    assert runs[0][2]["step"] == runs[1][2]["step"] == 4
    assert torch.equal(runs[0][2]["generator"].get_state(), runs[1][2]["generator"].get_state())


def test_label_smoothing_step_matches_jax(setup):
    vocab, jax_model, flat = setup
    batch = make_batch(vocab, seed=2)
    opt = jax_optim.make_optimizer(64, WARMUP)
    _, jloss = jax_steps.make_xe_step(jax_model, opt, label_smoothing=0.1)(
        jax_state(flat, opt), {k: jnp.asarray(v) for k, v in batch.items()})
    model = port_model(vocab, flat)
    _, loss = steps.make_xe_step(model, label_smoothing=0.1)(port_state(model),
                                                             torch_batch(batch))
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    # the loss function alone, on the same log-probs
    lp = np.log(np.random.default_rng(3).dirichlet(np.ones(len(vocab)), size=(4, 5))
                ).astype(np.float32)
    t = np.random.default_rng(4).integers(0, len(vocab), size=(4, 5)).astype(np.int32)
    t[:, -1] = vocab.padding_idx
    want = float(jax_steps.label_smoothing_loss(jnp.asarray(lp), jnp.asarray(t), 0, 0.1))
    got = float(steps.label_smoothing_loss(torch.from_numpy(lp), torch.from_numpy(t), 0, 0.1))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_eval_loss_and_nll_match_jax(setup):
    vocab, jax_model, flat = setup
    batch = make_batch(vocab, seed=3)
    params = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    want = float(jax_steps.make_eval_loss_step(jax_model)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}))
    model = port_model(vocab, flat, dropout=0.1)
    model.train()
    got = float(steps.make_eval_loss_step(model)(torch_batch(batch)))
    assert model.training  # the mode is restored
    assert abs(got - want) <= LOSS_RTOL * abs(want)
    # fused_nll equals nll_loss over the f32 log-softmax, in both packages
    logits = np.random.default_rng(5).normal(size=(3, 6, 40)).astype(np.float32) * 4
    t = np.random.default_rng(6).integers(0, 40, size=(3, 6)).astype(np.int32)
    t[0, -2:] = 0
    lt, tt = torch.from_numpy(logits), torch.from_numpy(t)
    fused = float(steps.fused_nll(lt, tt, 0))
    plain = float(steps.nll_loss(torch.log_softmax(lt, -1), tt, 0))
    jfused = float(jax_steps.fused_nll(jnp.asarray(logits), jnp.asarray(t), 0))
    assert abs(fused - plain) <= 1e-6 * abs(plain)
    assert abs(fused - jfused) <= 1e-6 * abs(jfused)
    # bf16 logits: the upcast comes before the subtraction
    lb = lt.to(torch.bfloat16)
    jb = float(jax_steps.fused_nll(jnp.asarray(lb.float().numpy()).astype(jnp.bfloat16),
                                   jnp.asarray(t), 0))
    assert abs(float(steps.fused_nll(lb, tt, 0)) - jb) <= 1e-6 * abs(jb)


# bf16 mixed precision, measured on two batches: the loss within 1.2e-4
# relative of JAX's; gradient leaves within 0.14 of their max-abs (median
# 0.04-0.05), which is the spread of bf16 itself: JAX's own bf16 gradient
# lies as far from its f32 one (max 0.19, median 0.04-0.055)
MIXED_LOSS_RTOL = 5e-4
MIXED_GRAD_TOL = 0.25
MIXED_GRAD_MEDIAN = 0.1


@pytest.mark.parametrize("seed", [0, 4])
def test_mixed_precision_step_matches_jax(setup, seed):
    """The bf16 step against JAX's: the loss, every gradient leaf, and the
    port's distance from the f32 gradient no more than 1.5x JAX's own."""
    vocab, jax_model, flat = setup
    batch = make_batch(vocab, seed=seed)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want = jax_grads(jax_model, flat, jbatch, mixed=True)
    _, exact = jax_grads(jax_model, flat, jbatch)
    model = port_model(vocab, flat)
    state = port_state(model)
    _, loss = steps.make_xe_step(model, mixed_precision=True)(state, torch_batch(batch))
    assert abs(float(loss) - want_loss) <= MIXED_LOSS_RTOL * abs(want_loss)
    for p in model.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
    errors = assert_grads_match(model, want, MIXED_GRAD_TOL, flat)
    assert np.median(list(errors.values())) <= MIXED_GRAD_MEDIAN
    port_gap = assert_grads_match(model, exact, 1.0, flat)
    jax_gap = {}
    for key in flat:
        scale = float(np.abs(exact[key]).max())
        if not key.endswith("fc_k/bias"):
            jax_gap[key] = float(np.abs(want[key] - exact[key]).max()) / scale
    port_gap = [v for k, v in port_gap.items() if k in jax_gap]
    assert np.median(port_gap) <= 1.5 * np.median(list(jax_gap.values()))


@pytest.mark.parametrize("mixed", [False, True])
def test_gradients_finite_on_ragged_batch(setup, mixed):
    """Padded regions and padded caption positions keep every gradient
    finite (no NaN from masked rows reaches the backward)."""
    vocab, _, flat = setup
    batch = make_batch(vocab, seed=8, bs=8, ragged=True)
    assert (batch["region_features"] == 0).all(-1).any()
    model = port_model(vocab, flat, dropout=0.1)
    state = port_state(model)
    _, loss = steps.make_xe_step(model, mixed_precision=mixed)(state, torch_batch(batch))
    assert torch.isfinite(loss)
    for name, p in model.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        assert torch.isfinite(p).all(), name


def test_dropout_seed_reproduces_losses(setup):
    vocab, _, flat = setup
    batches = [torch_batch(make_batch(vocab, seed=s)) for s in range(3)]

    def run(seed):
        model = port_model(vocab, flat, dropout=0.1)
        state = port_state(model, seed=seed)
        before = torch.random.get_rng_state()
        losses = steps.make_xe_multi_step(model)(state, batches)[1]
        assert torch.equal(torch.random.get_rng_state(), before)  # the global RNG is untouched
        return losses

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_noam_schedule_and_fast_forward_match_optax():
    jsched = jax_optim.noam_schedule(512, 10000, base_lr=1.0)
    sched = optim.noam_schedule(512, 10000, base_lr=1.0)
    counts = [0, 1, 9, 9999, 10000, 50000]
    np.testing.assert_allclose([sched(c) for c in counts], [float(jsched(c)) for c in counts],
                               rtol=1e-6)
    # the LambdaLR's learning rate at each update equals optax's schedule(count)
    p = torch.nn.Parameter(torch.zeros(3))
    opt, lr = optim.make_optimizer([p], 512, 10000)
    seen = []
    for _ in range(4):
        seen.append(opt.param_groups[0]["lr"])
        p.grad = torch.ones(3)
        opt.step()
        lr.step()
    np.testing.assert_allclose(seen, [float(jsched(c)) for c in range(4)], rtol=1e-6)


def _adam_pair(rng, fast_forward=None):
    """One update of optax and of the port's optimizer from the same
    parameters and gradients: (optax params, port params)."""
    w = rng.normal(size=(5, 4)).astype(np.float32)
    grads = [rng.normal(size=(5, 4)).astype(np.float32) for _ in range(3)]
    jopt = jax_optim.make_optimizer(64, 4)
    jp = {"w": jnp.asarray(w)}
    js = jopt.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(w.copy()))
    opt, sched = optim.make_optimizer([p], 64, 4)
    if fast_forward is not None:
        js = jax_optim.fast_forward_schedule(js, fast_forward)
        # moments from earlier updates are dropped by the port's fast-forward
        p.grad = torch.ones_like(p)
        opt.step()
        sched.step()
        optim.fast_forward_schedule(opt, sched, fast_forward)
        p.data.copy_(torch.from_numpy(w))
    for g in grads:
        updates, js = jopt.update({"w": jnp.asarray(g)}, js, jp)
        jp = optax.apply_updates(jp, updates)
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        sched.step()
    return np.asarray(jp["w"]), p.detach().numpy()


@pytest.mark.parametrize("fast_forward", [None, 37])
def test_adam_updates_match_optax(fast_forward):
    want, got = _adam_pair(np.random.default_rng(0), fast_forward)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_rl_optimizer_and_frozen_mask():
    w = np.random.default_rng(1).normal(size=(3,)).astype(np.float32)
    g = np.random.default_rng(2).normal(size=(3,)).astype(np.float32)
    jopt = jax_optim.make_rl_optimizer(5e-6)
    jp = {"w": jnp.asarray(w)}
    updates, _ = jopt.update({"w": jnp.asarray(g)}, jopt.init(jp), jp)
    want = np.asarray(optax.apply_updates(jp, updates)["w"])
    p = torch.nn.Parameter(torch.from_numpy(w.copy()))
    opt = optim.make_rl_optimizer([p], 5e-6)
    p.grad = torch.from_numpy(g)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6, atol=1e-12)

    class WithBackbone(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = torch.nn.Linear(2, 2)
            self.head = torch.nn.Linear(2, 2)

    assert optim.frozen_param_mask(torch.nn.Linear(2, 2)) is None
    assert jax_optim.frozen_param_mask({"head": {"kernel": jnp.zeros(2)}}) is None
    mask = optim.frozen_param_mask(WithBackbone())
    assert mask == {"backbone.weight": False, "backbone.bias": False,
                    "head.weight": True, "head.bias": True}
    model = WithBackbone()
    assert [id(p) for p in optim.mask_frozen(model)] == [id(model.head.weight),
                                                         id(model.head.bias)]
    assert len(optim.mask_frozen(torch.nn.Linear(2, 2))) == 2


# -- the kernels refuse a gradient, as JAX's grad refuses its Pallas kernels
def _attention_inputs(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, 5, 2, 8)).astype(np.float32)
    boxes = rng.uniform(0, 50, size=(2, 5, 4)).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + 5.0
    return q, boxes, rng.normal(size=(16, 2)).astype(np.float32)


def _jax_kernel_call(name):
    from openviic_tpu.ops.beam_select_attention import beam_select_attention
    from openviic_tpu.ops.geo_attention import geo_fused_attention
    from openviic_tpu.ops.head_topk import head_topk
    from openviic_tpu.ops.pallas_attention import fused_attention

    q, boxes, fc_g = _attention_inputs()
    mask = jnp.zeros((2, 1, 1, 5), bool)
    calls = {
        "fused_attention": (lambda x: fused_attention(x, x, x, bias=None, sm_scale=0.25).sum(),
                            q),
        "head_topk": (lambda x: head_topk(x, jnp.ones((8, 200)), 5)[0].sum(), q[0, :4, 0]),
        "beam_select_attention": (lambda x: beam_select_attention(
            x[:, :1], x, x, jnp.zeros((1, 2, 5), jnp.int32), mask).sum(), q),
        "geo_fused_attention": (lambda x: geo_fused_attention(
            x, x, x, jnp.asarray(boxes), jnp.asarray(fc_g), jnp.zeros(2), mask, 0.25).sum(), q),
    }
    fn, arg = calls[name]
    return lambda: jax.grad(fn)(jnp.asarray(arg))


def _port_kernel_call(name, x):
    from openviic_tpu_torch.ops.beam_select_attention import beam_select_attention
    from openviic_tpu_torch.ops.fused_attention import fused_attention
    from openviic_tpu_torch.ops.fused_decoder_step import fused_layer_step
    from openviic_tpu_torch.ops.geo_attention import geo_fused_attention
    from openviic_tpu_torch.ops.head_topk import head_topk
    from openviic_tpu_torch.ops.resident_layer_step import resident_layer_step

    _, boxes, fc_g = _attention_inputs()
    mask = torch.zeros((2, 1, 1, 5), dtype=torch.bool)
    D, n = 16, 2
    if name == "fused_attention":
        return fused_attention(x, x, x, bias=None, sm_scale=0.25)
    if name == "head_topk":
        return head_topk(x[0, :4, 0], torch.ones((200, 8)), 5)[0]
    if name == "beam_select_attention":
        return beam_select_attention(x[:, :1], x, x, torch.zeros((1, 2, 5), dtype=torch.long),
                                     mask)
    if name == "geo_fused_attention":
        return geo_fused_attention(x, x, x, torch.from_numpy(boxes), torch.from_numpy(fc_g),
                                   torch.zeros(2), mask, 0.25)
    flat = x.reshape(2, 5, D)
    weights = {"w1": torch.zeros(D, 32)}
    if name == "fused_layer_step":
        return fused_layer_step(flat[:, 0], flat, flat, flat, flat, mask[:, 0, 0],
                                mask[:, 0, 0], 1, weights, n_heads=n)
    return resident_layer_step(flat[:, 0], flat.reshape(2, 5, n, 8), flat.reshape(2, 5, n, 8),
                               flat[:1].reshape(1, 5, n, 8), flat[:1].reshape(1, 5, n, 8),
                               torch.zeros((1, 2, 5), dtype=torch.long), mask, mask[:1],
                               torch.zeros((2, 1), dtype=torch.bool), 1, weights, n_heads=n)


JAX_KERNELS = ("fused_attention", "head_topk", "beam_select_attention", "geo_fused_attention")
PORT_ONLY = ("fused_layer_step", "resident_layer_step")


@pytest.mark.parametrize("name", JAX_KERNELS + PORT_ONLY)
def test_kernels_refuse_a_gradient_like_jax(name):
    if name in JAX_KERNELS:  # JAX's grad refuses the Pallas kernel (interpret mode)
        with pytest.raises((AssertionError, ValueError)):
            _jax_kernel_call(name)()
    q = torch.from_numpy(_attention_inputs()[0]).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward.*OPENVIIC_PALLAS"):
        _port_kernel_call(name, q)
    if name in PORT_ONLY:
        return
    # under no_grad, or with inputs that need no gradient, nothing changes
    with torch.no_grad():
        quiet = _port_kernel_call(name, q)
    plain = _port_kernel_call(name, q.detach())
    for a, b in zip(quiet if isinstance(quiet, tuple) else (quiet,),
                    plain if isinstance(plain, tuple) else (plain,)):
        assert torch.equal(a, b)


def test_xe_step_refuses_the_fused_attention_flag_like_jax(setup, monkeypatch):
    vocab, jax_model, flat = setup
    batch = make_batch(vocab, seed=1)
    monkeypatch.setenv("OPENVIIC_PALLAS", "1")
    opt = jax_optim.make_optimizer(64, WARMUP)
    with pytest.raises(AssertionError):
        jax_steps.make_xe_step(jax_model, opt)(jax_state(flat, opt),
                                               {k: jnp.asarray(v) for k, v in batch.items()})
    model = port_model(vocab, flat)
    with pytest.raises(RuntimeError, match="fused_attention has no backward"):
        steps.make_xe_step(model)(port_state(model), torch_batch(batch))
    # the eval loss runs under no_grad and goes through the kernel's plain version
    monkeypatch.delenv("OPENVIIC_PALLAS")
    want = float(steps.make_eval_loss_step(model)(torch_batch(batch)))
    monkeypatch.setenv("OPENVIIC_PALLAS", "1")
    got = float(steps.make_eval_loss_step(model)(torch_batch(batch)))
    assert abs(got - want) <= 1e-5 * abs(want)
