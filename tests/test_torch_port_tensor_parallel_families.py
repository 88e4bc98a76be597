"""Tensor parallelism on every family the port builds
(``openviic_tpu_torch.parallel.tensor_parallel``, the decode's kernels
under a ``model`` axis) on the CPU, against the JAX package's
``param_shardings`` and ``make_sharded_xe_step`` over {data 1, model 2} and
its beam search from parameters placed by those shardings, on the virtual
devices of ``tests/conftest.py``.

The families at the test width (``tests/torch_port_families.py``: d_model
16, 2 heads of 8, d_ff 32), dropout 0: AoA, the augmented memory, M², CAMO
(its one-head encoder attention, which a 2-wide axis does not divide: its
q, k and v gathered to the whole head), the ORT with the trig embedding on
and off, DLCT, RSTNet (the mini backbone) and the flagship with a 4-expert
Switch MoE on every FFN and ``LSTMTextEmbedding``.  The port's two ranks
come from one gloo spawn a module (``tests/torch_port_layouts_worker.py
tp_families``), started before JAX's side runs, fed the same numpy-drawn
weights and inputs.

Bars: the XE loss 1e-5 relative and the parameters after two SGD steps
2e-4 / 1e-5 (``tests/test_tensor_parallel.py``'s); the f32 beam decode's
tokens equal to JAX's on both ranks, its log-probs within 1e-5 (DLCT's
within ``DLCT_LP_ATOL``, its encoder's sin/cos bar); the kernel flags, on
the kernels' plain versions, against JAX's decode from its sharded
parameters under the same flag (its Pallas kernels in interpret mode) and
one process's, with ``tests/torch_port_families.py``'s bars against JAX:
``resident_kernel`` the best beam's tokens equal and its log-probs within
``RESIDENT_ATOL`` (``assert_best_beams_match``), each rank's first layer
call within ``check_resident_call``'s bars of JAX's kernel, the others
every token equal and log-probs within ``BEAM_ATOL``."""

import contextlib
import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from openviic_tpu.builders import build_model as build_jax_model
from openviic_tpu.config import ConfigNode as JaxConfigNode
from openviic_tpu.decoding import beam_search as jax_beam_search
from openviic_tpu.parallel import batch_sharding
from openviic_tpu.parallel import make_mesh as jax_make_mesh
from openviic_tpu.parallel import make_sharded_xe_step as jax_sharded_xe_step
from openviic_tpu.parallel.mesh import param_shardings as jax_param_shardings
from openviic_tpu.parallel.mesh import shard_state as jax_shard_state
from openviic_tpu_torch.builders import build_model
from openviic_tpu_torch.compat.from_jax import load_jax_params, state_dict_from_jax, torch_name
from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.parallel import dryrun
from openviic_tpu_torch.parallel.tensor_parallel import shard_model, shard_optimizer_state
from openviic_tpu_torch.training import optim
from openviic_tpu_torch.training.steps import init_xe_state, make_xe_step
from tests.test_torch_port_distributed import SPAWN_TIMEOUT
from tests.test_torch_port_moe_lstm import moe_lstm_config, scaled
from tests.test_torch_port_ort import ort_config, pixel_boxes
from tests.test_torch_port_support import random_params
from tests.test_torch_port_tensor_expert_parallel import WORKER, world_mesh
from tests.torch_port_families import (
    BEAM_ATOL,
    RESIDENT_ATOL,
    _xe_batch,
    assert_best_beams_match,
    check_resident_call,
    eager_resident_kernel,
    family_batch,
    family_config,
    make_vocab,
)
from tests.torch_port_layouts_worker import FAMILY_FLAGS
from tests.torch_port_rstnet import rstnet_model

LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-4, 1e-5
LP_ATOL = 1e-5
DLCT_LP_ATOL = 2e-4  # its box embedding's sin/cos of ~690 rad (tests/torch_port_families.py)
SGD_LR = 0.05
XE_STEPS, BEAM, XE_BS, DECODE_BS = 2, 3, 4, 3
COMPILE_THREADS = 3

# family: the beam_search flags run on it (``torch_port_layouts_worker.FAMILY_FLAGS``);
# M² and the MoE decoder leave out the layer kernels, which fail on them
# in both packages (tests/test_torch_port_families_meshed_memory.py,
# tests/test_torch_port_moe_lstm.py)
LAYER_AND_ATTN = ("resident_kernel", "attn_kernel", "fused_step")
FAMILIES = {
    "aoa": LAYER_AND_ATTN,
    "augmented_memory": LAYER_AND_ATTN,
    "meshed_memory": ("attn_kernel", "fused_step"),
    "camo": LAYER_AND_ATTN,
    "ort": LAYER_AND_ATTN,
    "ort_trig": LAYER_AND_ATTN + ("geo_fused",),
    "dlct": LAYER_AND_ATTN,
    "rstnet": LAYER_AND_ATTN,
    "moe_lstm": ("attn_kernel",),
}
# the families whose decoder layers the whole-layer kernels run (AoA's
# gate, M²'s and RSTNet's layers keep them off, as in JAX)
LAYER_KERNEL_FAMILIES = ("augmented_memory", "camo", "ort", "ort_trig", "dlct")
FLAG_CASES = [(f, flag) for f, flags in FAMILIES.items() for flag in flags]


def _walk(node, dropout=0.0):
    if isinstance(node, dict):
        return {k: (dropout if k == "DROPOUT" else _walk(v, dropout)) for k, v in node.items()}
    return node


def _streams(name: str, bs: int, seed: int) -> dict:
    """The family's input streams (numpy): regions, and the ORT's boxes in
    pixels, DLCT's four streams."""
    if name == "dlct":
        return family_batch("dlct", bs, seed=seed)
    streams = family_batch("aoa", bs, seed=seed)
    if name.startswith("ort"):
        streams["region_boxes"] = pixel_boxes(bs, 6, seed=seed)
    return streams


def family_case(name: str):
    """(MODEL tree at dropout 0, vocab, JAX model, flat parameters)."""
    vocab = make_vocab()
    if name in ("ort", "ort_trig"):
        config = _walk(ort_config(name == "ort_trig").to_dict())
    elif name == "rstnet":
        config = rstnet_model(pretrained=False, dropout=0.0)
    elif name == "moe_lstm":
        config = moe_lstm_config(dropout=0.0)
    else:
        config = family_config(name, dropout=0.0)
    jax_model = build_jax_model(JaxConfigNode(config), vocab)
    batch = _streams(name, 2, 0) if name in ("dlct", "ort", "ort_trig") else None
    flat = random_params(jax_model, vocab, 0, -6.0 if name != "meshed_memory" else 6.0,
                         shapes_only=True, batch=batch)
    if name == "moe_lstm":
        flat = scaled(flat)
    return config, vocab, jax_model, flat


def xe_batches(name: str, vocab) -> list:
    out = []
    for step in range(XE_STEPS):
        batch = _xe_batch("dlct" if name == "dlct" else "aoa", vocab, bs=XE_BS, seed=5 + step)
        if name != "dlct":
            batch.update({k: v for k, v in _streams(name, XE_BS, 5 + step).items()
                          if k != "region_features"})
        out.append(batch)
    return out


@contextlib.contextmanager
def _env(var):
    """``var`` set to 1 while a decode traces (the JAX kernels' flags are
    read then), and restored after."""
    old = os.environ.get(var) if var else None
    if var:
        os.environ[var] = "1"
    try:
        yield
    finally:
        if var:
            os.environ.pop(var, None)
            if old is not None:
                os.environ[var] = old


def _run(lowered, *args) -> tuple:
    """``lowered`` compiled and run on ``args``, its outputs in numpy."""
    return tuple(np.asarray(x) for x in lowered.compile()(*args))


def _train(step, state, batches) -> tuple:
    """The XE step taken on each batch: (losses, the parameters after,
    flat).  The state goes back on the shardings ``shard_state`` gave it
    before each step (the step returns some leaves under the equivalent
    P('model') for P('model', None); no data moves), so every step runs
    the first one's program instead of compiling a second."""
    shardings = jax.tree_util.tree_map(lambda x: x.sharding, state)
    losses = []
    for batch in batches:
        state, loss = step(jax.device_put(state, shardings), batch)
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in
                    traverse_util.flatten_dict(state["params"], sep="/").items()}


def jax_decodes(pool, name, jax_model, flat, programs) -> dict:
    """JAX's beam decode from the parameters placed by ``param_shardings``
    over {data 1, model 2}, unflagged (``None``) and under each of the
    family's flags (its Pallas kernels in interpret mode, partitioned by
    GSPMD), and those specs.  Each decode is lowered here, where the flags
    are read, and compiled and run on ``pool`` (XLA's compile and run
    release the GIL) while the next one lowers; one lowered to the text of
    an earlier one (RSTNet's decoder turns every flag off) shares its run
    through ``programs``.  The decodes are futures."""
    mesh = jax_make_mesh({"data": 1, "model": 2}, jax.devices()[:2])
    placed = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    shardings = jax_param_shardings(placed, mesh)
    specs = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(sh.spec)
             for path, sh in jax.tree_util.tree_flatten_with_path(shardings)[0]}
    placed = jax.device_put(placed, shardings)
    batch = {k: jnp.asarray(v) for k, v in _streams(name, DECODE_BS, 4).items()}
    decodes = {}
    for flag in (None, *FAMILIES[name]):
        env, kwargs = FAMILY_FLAGS[flag] if flag else (None, {})
        with _env(env):
            lowered = jax.jit(lambda p, b, _kw=kwargs: jax_beam_search(
                jax_model, p, b, beam_size=BEAM, out_size=BEAM, **_kw)).lower(placed, batch)
        key = hashlib.sha256(lowered.as_text().encode()).hexdigest()
        if key not in programs:
            programs[key] = pool.submit(_run, lowered, placed, batch)
        decodes[flag] = programs[key]
    return {"specs": specs, "decodes": decodes}


def jax_xe(pool, name, vocab, jax_model, flat):
    """JAX's two SGD XE steps over {data 1, model 2} on ``pool``: submitted
    once no flag is set, since the step traces there."""
    mesh = jax_make_mesh({"data": 1, "model": 2}, jax.devices()[:2])

    def tree():  # the sharded step donates its state
        return traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                                            sep="/")
    optimizer = optax.sgd(SGD_LR)
    state = jax_shard_state({"params": tree(), "opt_state": optimizer.init(tree()),
                             "step": jnp.zeros((), jnp.int32),
                             "rng": jax.random.PRNGKey(0)}, mesh, optimizer)
    batches = [jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                              batch_sharding(mesh)) for batch in xe_batches(name, vocab)]
    return pool.submit(_train, jax_sharded_xe_step(jax_model, optimizer, mesh), state, batches)


@pytest.fixture(scope="module")
def cases():
    return {name: family_case(name) for name in FAMILIES}


@pytest.fixture(scope="module")
def runs(cases, tmp_path_factory):
    """JAX's side of every family, computed while the worker's two ranks
    run; their results under ``ranks``."""
    directory = tmp_path_factory.mktemp("tp_families")
    job = {"xe_steps": XE_STEPS, "beam": BEAM, "families": {}}
    for name, (config, vocab, _, flat) in cases.items():
        job["families"][name] = {"model": config, "vocab": len(vocab),
                                 "max_len": vocab.max_caption_length,
                                 "flags": list(FAMILIES[name])}
        np.savez(directory / f"tpf_{name}_params.npz", **flat)
        arrays = {f"xe{i}_{k}": v for i, b in enumerate(xe_batches(name, vocab))
                  for k, v in b.items()}
        arrays.update({f"decode_{k}": v for k, v in _streams(name, DECODE_BS, 4).items()})
        np.savez(directory / f"tpf_{name}_batches.npz", **arrays)
    (directory / "tpf.json").write_text(json.dumps(job))
    procs = dryrun.start([str(WORKER), "tp_families", str(directory)], 2, str(directory))
    try:
        programs: dict = {}
        with ThreadPoolExecutor(COMPILE_THREADS) as pool:
            sides = {name: jax_decodes(pool, name, jax_model, flat, programs)
                     for name, (_, _, jax_model, flat) in cases.items()}
            steps = {name: jax_xe(pool, name, vocab, jax_model, flat)
                     for name, (_, vocab, jax_model, flat) in cases.items()}
            out = {}
            for name, side in sides.items():
                losses, params = steps[name].result()
                decodes = {flag: run.result() for flag, run in side["decodes"].items()}
                out[name] = {"losses": losses, "params": params, "specs": side["specs"],
                             "decode": decodes.pop(None), "flags": decodes}
    finally:
        dryrun.wait(procs, str(directory), SPAWN_TIMEOUT)
    ranks = [torch.load(directory / f"tp_families_rank{r}.pt", weights_only=False)
             for r in range(2)]
    return {"jax": out, "ranks": ranks}


# ------------------------------------------------------------- the rules


@pytest.mark.parametrize("name", list(FAMILIES))
def test_tp_rules_shard_every_family_as_jax(runs, name):
    """Each family's sharded leaves are JAX's (transposed for a kernel):
    AoA's gates, the memory slots, M²'s gates, CAMO's MLP, ``fc_gs``, the
    language model's backbone and the stacked experts replicated."""
    want = runs["jax"][name]["specs"]
    for rank in runs["ranks"]:
        got = rank[name]["specs"]
        assert set(got) == {torch_name(k)[0] for k in want}
        for key, spec in want.items():
            n, transpose = torch_name(key)
            assert got[n] == (tuple(reversed(spec)) if transpose and len(spec) == 2 else spec), key
    replicated = {"aoa": "informative_attention", "augmented_memory": "m_k",
                  "meshed_memory": "fc_alpha_0", "camo": "mlp1", "ort": "fc_gs",
                  "ort_trig": "fc_gs", "dlct": "fc_gs", "rstnet": "backbone",
                  "moe_lstm": "pwff.w1"}[name]
    names = [n for n in runs["ranks"][0][name]["specs"] if replicated in n]
    assert names and all(runs["ranks"][0][name]["specs"][n] == () for n in names)


def test_every_family_builds_its_heads_layout(runs):
    """CAMO's one-head encoder attentions gather whole heads (their fc_q a
    4-row shard of the 8-wide head); every other attention keeps one of
    its two heads a rank."""
    for name in FAMILIES:
        layouts = runs["ranks"][0][name]["layouts"]
        assert layouts, name
        for module, (layout, heads) in layouts.items():
            one_head = name == "camo" and module.startswith("encoder.")
            assert (layout, heads) == (("gathered", 1) if one_head else ("heads", 1)), \
                (name, module)
    shapes = runs["ranks"][0]["camo"]["local_shapes"]
    assert shapes["encoder.layers.0.mhatt.attention.fc_q.weight"] == (4, 16)
    assert shapes["encoder.self_attn.attention.fc_o.weight"] == (16, 4)


# ------------------------------------------------------------- XE steps


@pytest.mark.parametrize("name", list(FAMILIES))
def test_tp_xe_steps_match_jax(runs, cases, name):
    config, vocab, _, _ = cases[name]
    want = runs["jax"][name]
    # JAX's parameters after the steps in the port's names and layout
    ref = state_dict_from_jax(want["params"], build_model(ConfigNode(config), vocab,
                                                          device="cpu", init=False))
    for rank in runs["ranks"]:
        got = rank[name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
        for n, value in got["params"].items():
            torch.testing.assert_close(value, ref[n], rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       msg=lambda m, n=n: f"{n}: {m}")
    first, second = (r[name]["params"] for r in runs["ranks"])
    assert all(torch.equal(first[n], second[n]) for n in first)


def test_aoa_gate_reads_the_all_reduced_output(runs, cases):
    """The gate's two linears stay whole and equal on both ranks after the
    steps, and moved as JAX's did: it reads the attention's row-parallel
    output summed over the axis, which every rank holds."""
    _, _, _, flat = cases["aoa"]
    gates = [n for n in runs["ranks"][0]["aoa"]["params"]
             if "informative_attention" in n or "gated_attention" in n]
    assert len(gates) == 2 * 2 * 6  # weight and bias of both, in 2 + 2 x 2 attentions
    for n in gates:
        full = runs["ranks"][0]["aoa"]["local_shapes"][n]
        assert full == tuple(runs["ranks"][0]["aoa"]["params"][n].shape)
        assert torch.equal(runs["ranks"][0]["aoa"]["params"][n],
                           runs["ranks"][1]["aoa"]["params"][n])
    start = {torch_name(k)[0]: (v.T if torch_name(k)[1] else v) for k, v in flat.items()}
    assert any(not np.allclose(runs["ranks"][0]["aoa"]["params"][n].numpy(), start[n])
               for n in gates)


# ------------------------------------------------------------- decode


@pytest.mark.parametrize("name", list(FAMILIES))
def test_tp_decode_tokens_equal_jax(runs, name):
    want_tokens, want_lp = runs["jax"][name]["decode"]
    atol = DLCT_LP_ATOL if name == "dlct" else LP_ATOL
    for rank in runs["ranks"]:
        tokens, lp = rank[name]["decode"]
        np.testing.assert_array_equal(tokens.numpy(), want_tokens.reshape(tokens.shape))
        np.testing.assert_allclose(lp.numpy(), want_lp.reshape(lp.shape), atol=atol, rtol=0)


@pytest.mark.parametrize("name,flag", FLAG_CASES, ids=[f"{n}-{f}" for n, f in FLAG_CASES])
def test_tp_kernel_flags_match_one_process(runs, cases, name, flag, monkeypatch):
    """Every decode flag runs under the axis, held against JAX's decode
    under the same flag from its sharded parameters (its Pallas kernels in
    interpret mode) and against one process's: the whole-layer kernels on
    every head (``n_heads`` the whole count) where the family's layers take
    them and never elsewhere, the beam-select kernel on the rank's head,
    the geometry kernel on the rank's head of ``fc_gs``."""
    config = cases[name][0]
    n_layers = config["DECODER"]["LAYERS"]
    want_tokens, want_lp = runs["jax"][name]["flags"][flag]
    atol = max(BEAM_ATOL, DLCT_LP_ATOL) if name == "dlct" else BEAM_ATOL
    eager_resident_kernel(monkeypatch)  # JAX's kernel op by op, bit for bit
    for rank in runs["ranks"]:
        case = rank[name]["flags"][flag]
        (tokens, lp), (one_tokens, one_lp) = case["got"], case["one"]
        want_tokens, want_lp = (want_tokens.reshape(tokens.shape), want_lp.reshape(lp.shape))
        if flag == "resident_kernel":
            assert_best_beams_match(tokens[:, 0], lp[:, 0], want_tokens[:, 0], want_lp[:, 0],
                                    runs["jax"][name]["decode"][0].reshape(tokens.shape)[:, 0])
            assert torch.equal(tokens[:, 0], one_tokens[:, 0])
            torch.testing.assert_close(lp, one_lp, atol=RESIDENT_ATOL, rtol=0)
        else:
            np.testing.assert_array_equal(tokens.numpy(), want_tokens)
            np.testing.assert_allclose(lp.numpy(), want_lp, atol=atol, rtol=0)
            assert torch.equal(tokens, one_tokens)
            torch.testing.assert_close(lp, one_lp, atol=BEAM_ATOL, rtol=0)
        calls = case["calls"]
        layer_kernel = {"resident_kernel": "resident_layer_step",
                        "fused_step": "fused_layer_step"}.get(flag)
        if layer_kernel is not None:
            if name in LAYER_KERNEL_FAMILIES:
                assert calls[layer_kernel] % n_layers == 0 and calls[layer_kernel] >= n_layers
                assert calls["n_heads"] == {2}
                if flag == "resident_kernel":  # the rank's first call against JAX's kernel
                    check_resident_call(*calls["first_resident"])
            else:
                assert layer_kernel not in calls
        elif flag == "attn_kernel":  # RSTNet's decoder turns every flag off, as JAX's
            selects = calls.get("beam_select_attention", 0)
            assert selects % n_layers == 0 and (selects > 0) == (name != "rstnet")
        else:
            assert calls["geo_fused_attention"] == config["ENCODER"]["LAYERS"]


def test_rstnet_signal_table_is_the_same_on_every_rank(runs):
    """The language model's sharded ``encoder_layer`` gives one table on
    both ranks, within 1e-5 of one process's, and the decode through it
    equals the per-step language model's."""
    first, second = (r["rstnet"] for r in runs["ranks"])
    assert torch.equal(first["table"], second["table"])
    torch.testing.assert_close(first["table"], first["one_table"], atol=1e-5, rtol=0)
    for rank in (first, second):
        assert torch.equal(rank["table_decode"][0], rank["decode"][0])
        torch.testing.assert_close(rank["table_decode"][1], rank["decode"][1], atol=1e-5,
                                   rtol=0)


def test_rstnet_masked_adam_shards_without_the_frozen_moments(cases):
    """``shard_optimizer_state`` on RSTNet's masked Adam (``optim.mask_frozen``):
    the sharded parameters' moments cut to their shards, the frozen
    backbone with no state at all."""
    config, vocab, _, flat = cases["rstnet"]
    model = load_jax_params(build_model(ConfigNode(config), vocab, device="cpu"), flat)
    optimizer = torch.optim.Adam(optim.mask_frozen(model), lr=1e-3)
    batch = {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
             for k, v in xe_batches("rstnet", vocab)[0].items()}
    make_xe_step(model)(init_xe_state(model, optimizer, seed=0), batch)
    mesh = world_mesh({"model": 2})
    specs = shard_model(model, mesh)
    shard_optimizer_state(model, optimizer, specs, mesh)
    frozen = [n for n in specs if ".backbone." in n]
    assert frozen and all(not optimizer.state.get(p) for n, p in model.named_parameters()
                          if n in frozen)
    cut = 0
    for n, p in model.named_parameters():
        if specs[n] and n not in frozen:
            assert optimizer.state[p]["exp_avg"].shape == p.shape, n
            cut += 1
    assert cut and any(".language_model.encoder_layer." in n for n, s in specs.items() if s)


def test_one_head_encoder_matches_the_full_head_in_one_process(cases):
    """CAMO's one-head attention on a 2-wide axis, rank by rank without a
    group: each rank's column shards of q, k and v side by side are the
    whole head (what the all-gather gives), and the ranks' row-parallel
    ``fc_o`` products of their columns of the attention, summed (what the
    all-reduce gives), equal one process's output."""
    from openviic_tpu_torch.models.attention import ScaledDotProductAttention

    config, vocab, _, flat = cases["camo"]

    def fresh():
        return load_jax_params(build_model(ConfigNode(config), vocab, device="cpu"), flat).eval()

    whole = fresh().encoder.self_attn.attention
    assert type(whole) is ScaledDotProductAttention and whole.h == 1
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 5, 16)).astype(np.float32))
    ranks = []
    for index in range(2):
        model = fresh()
        shard_model(model, world_mesh({"model": 2}, index))
        ranks.append(model.encoder.self_attn.attention)
        assert ranks[-1].gathered_heads is not None and ranks[-1].h == 1
    with torch.no_grad():
        want = whole(x, x, x)
        q, k, v = (torch.cat([getattr(r, fc)(x) for r in ranks], dim=-1)
                   for fc in ("fc_q", "fc_k", "fc_v"))
        att = torch.softmax(q @ k.transpose(1, 2) / 8 ** 0.5, dim=-1) @ v
        got = sum(torch.nn.functional.linear(att[..., 4 * i:4 * (i + 1)], r.fc_o.weight)
                  for i, r in enumerate(ranks)) + ranks[0].fc_o.bias
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
