"""The port's tensor and expert parallelism across processes
(``openviic_tpu_torch.parallel.tensor_parallel``, the ``model`` and
``expert`` axes of ``parallel.mesh``, the vocab-parallel decode) on the
CPU, against the JAX package's ``param_shardings``, ``shard_state`` and
``make_sharded_xe_step`` on the virtual devices of ``tests/conftest.py``.

The port's ranks come from one 4-rank gloo spawn a module
(``tests/torch_port_layouts_worker.py tp_ep``), fed the same numpy-drawn
weights and inputs as JAX; world-1 cases run in this process.
Tolerances are JAX's own tests': the XE loss 1e-5 relative, the
parameters after SGD steps 2e-4 / 1e-5 (``tests/test_tensor_parallel.py``),
the expert-parallel encoder 1e-5 and its gradients 2e-4 / 1e-4
(``tests/test_expert_parallel.py``); decodes: tokens equal, and under the
kernel flags (their plain versions) ``tests/torch_port_families.py``'s
bars against one process's decode under the same flag."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from openviic_tpu.builders import build_model as build_jax_model
from openviic_tpu.decoding import beam_search as jax_beam_search
from openviic_tpu.parallel import batch_sharding
from openviic_tpu.parallel import make_mesh as jax_make_mesh
from openviic_tpu.parallel import make_sharded_xe_step as jax_sharded_xe_step
from openviic_tpu.parallel.mesh import param_shardings as jax_param_shardings
from openviic_tpu.parallel.mesh import shard_state as jax_shard_state
from openviic_tpu_torch.builders import build_model
from openviic_tpu_torch.compat.from_jax import load_jax_params, torch_name
from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.decoding import beam_search
from openviic_tpu_torch.ops.head_topk import head_topk_reference
from openviic_tpu_torch.parallel import dryrun
from openviic_tpu_torch.parallel.mesh import Mesh
from openviic_tpu_torch.parallel.tensor_parallel import (
    local_shard,
    merge_shard_topk,
    param_shardings,
    shard_model,
)
from tests.helpers import model_config
from tests.test_expert_parallel import _moe_encoder_setup
from tests.test_tensor_parallel import _no_dropout
from tests.test_torch_port_distributed import SPAWN_TIMEOUT, WORKER
from tests.test_torch_port_support import make_vocab, random_params

WORKER = WORKER.parent / "torch_port_layouts_worker.py"
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-4, 1e-5
EP_ATOL, EP_GRAD_ATOL, EP_GRAD_RTOL = 1e-5, 2e-4, 1e-4
SGD_LR = 0.05
VOCAB, MAX_LEN, XE_STEPS, GLOBAL_BS, BEAM, DECODE_IMAGES, D_FEATURE = 32, 10, 2, 4, 3, 5, 13
XE_MESHES = {"dp2xtp2": {"data": 2, "model": 2}, "tp2": {"model": 2}, "dp4": {"data": 4},
             "tp4": {"model": 4}}


def world_mesh(axes: dict, index: int = 0) -> Mesh:
    """A mesh of ``axes`` as rank ``index`` sees it, without a process group
    (for the checks made before any collective)."""
    n = int(np.prod(list(axes.values())))
    return Mesh(axes, list(range(n)), index, {}, {})


def xe_batches(vocab):
    """Global batches of GLOBAL_BS with ragged regions and captions."""
    out = []
    for step in range(XE_STEPS):
        rng = np.random.default_rng(50 + step)
        feats = rng.normal(size=(GLOBAL_BS, 6, D_FEATURE)).astype(np.float32)
        tokens = np.full((GLOBAL_BS, MAX_LEN), vocab.padding_idx, np.int32)
        target = np.full((GLOBAL_BS, MAX_LEN), vocab.padding_idx, np.int32)
        for i in range(GLOBAL_BS):
            feats[i, 4 + i % 2:] = 0.0
            words = rng.integers(4, len(vocab), size=2 + (i * 3 + step) % (MAX_LEN - 3))
            enc = np.concatenate([[vocab.bos_idx], words, [vocab.eos_idx]])
            tokens[i, :len(enc) - 1] = enc[:-1]
            target[i, :len(enc) - 1] = enc[1:]
        out.append({"region_features": feats, "caption_tokens": tokens,
                    "shifted_right_caption_tokens": target})
    return out


@pytest.fixture(scope="module")
def setup():
    vocab = make_vocab(size=VOCAB, max_len=MAX_LEN)
    config = _no_dropout(model_config())
    jax_model = build_jax_model(config, vocab)
    flat = random_params(jax_model, vocab, seed=3, eos_gain=0.5, shapes_only=True)
    decode_feats = np.random.default_rng(9).normal(
        size=(DECODE_IMAGES, 6, D_FEATURE)).astype(np.float32)
    decode_feats[1, 4:] = 0.0
    return vocab, config, jax_model, flat, decode_feats


@pytest.fixture(scope="module")
def jax_runs(setup, tmp_path_factory):
    """JAX's side, computed while the worker's four ranks run; their results
    under ``ranks``."""
    vocab, config, jax_model, flat, decode_feats = setup
    directory = tmp_path_factory.mktemp("layouts_tp_ep")
    (directory / "tp.json").write_text(json.dumps(
        {"model": config.to_dict(), "vocab": VOCAB, "max_len": MAX_LEN, "xe_steps": XE_STEPS,
         "beam": BEAM}))
    np.savez(directory / "tp_params.npz", **flat)
    batches = xe_batches(vocab)
    arrays = {f"xe{i}_{k}": v for i, b in enumerate(batches) for k, v in b.items()}
    np.savez(directory / "tp_batches.npz", decode_region_features=decode_feats, **arrays)
    enc, params, features, padding_mask = _moe_encoder_setup()
    ep_cfg = model_config(layers=2).ENCODER
    ep_cfg.SELF_ATTENTION.MOE_EXPERTS = 4
    ep_cfg.SELF_ATTENTION.MOE_CAPACITY_FACTOR = 4.0
    ep_cfg.SELF_ATTENTION.DROPOUT = 0.0
    (directory / "ep.json").write_text(json.dumps({"encoder": ep_cfg.to_dict()}))
    ep_flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    np.savez(directory / "ep_params.npz", **ep_flat)
    np.savez(directory / "ep_inputs.npz", features=np.asarray(features),
             padding_mask=np.asarray(padding_mask))
    procs = dryrun.start([str(WORKER), "tp_ep", str(directory)], 4, str(directory))
    try:
        out = {"xe": {}}
        def fresh_tree():  # the sharded step donates its state
            return traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                                                sep="/")

        for name, axes in XE_MESHES.items():
            tree = fresh_tree()
            n = int(np.prod(list(axes.values())))
            mesh = jax_make_mesh({"data": 1, **axes}, jax.devices()[:n])  # JAX needs a data axis
            optimizer = optax.sgd(SGD_LR)
            state = jax_shard_state({"params": tree, "opt_state": optimizer.init(tree),
                                     "step": jnp.zeros((), jnp.int32),
                                     "rng": jax.random.PRNGKey(0)}, mesh, optimizer)
            step = jax_sharded_xe_step(jax_model, optimizer, mesh)
            losses = []
            for batch in batches:
                state, loss = step(state, jax.device_put(
                    {k: jnp.asarray(v) for k, v in batch.items()}, batch_sharding(mesh)))
                losses.append(float(loss))
            out["xe"][name] = (losses, {k: np.asarray(v) for k, v in
                                        traverse_util.flatten_dict(state["params"],
                                                                   sep="/").items()})
        tree = fresh_tree()
        mesh = jax_make_mesh({"data": 1, "model": 2}, jax.devices()[:2])
        out["specs"] = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(sh.spec)
                        for path, sh in jax.tree_util.tree_flatten_with_path(
                            jax_param_shardings(tree, mesh))[0]}
        adam = optax.adam(1e-3)
        sharded = jax_shard_state({"params": tree, "opt_state": adam.init(tree),
                                   "step": jnp.zeros((), jnp.int32),
                                   "rng": jax.random.PRNGKey(0)}, mesh, adam)
        mu = sharded["opt_state"][0].mu
        tree = fresh_tree()
        out["mu_shard_shapes"] = {
            "/".join(str(getattr(k, "key", k)) for k in path): leaf.sharding.shard_shape(
                leaf.shape) for path, leaf in jax.tree_util.tree_flatten_with_path(mu)[0]}
        tokens, logprobs = jax.jit(lambda p, f: jax_beam_search(
            jax_model, p, {"region_features": f}, beam_size=BEAM))(tree, jnp.asarray(decode_feats))
        out["decode"] = (np.asarray(tokens), np.asarray(logprobs))
        # from the {model 2} shards, the beam-select kernel in interpret mode
        out["attn_kernel_decode"] = tuple(np.asarray(x) for x in jax.jit(
            lambda p, f: jax_beam_search(jax_model, p, {"region_features": f}, beam_size=BEAM,
                                         attn_kernel=True))(
            jax.device_put(tree, jax_param_shardings(tree, mesh)), jnp.asarray(decode_feats)))
        dense = jax.jit(enc.apply)(params, features, padding_mask)
        grads = jax.jit(jax.grad(lambda p: jnp.sum(enc.apply(p, features, padding_mask) ** 2)))(
            params)
        out["ep"] = (np.asarray(dense), {k: np.asarray(v) for k, v in
                                         traverse_util.flatten_dict(grads, sep="/").items()})
    finally:
        dryrun.wait(procs, str(directory), SPAWN_TIMEOUT)
    out["ranks"] = [torch.load(directory / f"tp_ep_rank{r}.pt", weights_only=False)
                    for r in range(4)]
    return out


def assert_params_close(got: dict, want_flat: dict):
    for key, want in want_flat.items():
        name, transpose = torch_name(key)
        np.testing.assert_allclose(got[name].numpy(), want.T if transpose else want,
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=key)


# ------------------------------------------------------------- the rules


def test_tp_rules_shard_the_leaves_jax_shards_along_the_transposed_dim(setup, jax_runs):
    vocab, config, _, flat, _ = setup
    model = build_model(ConfigNode(config.to_dict()), vocab, device="cpu", init=False)
    got = param_shardings(model, world_mesh({"data": 1, "model": 2}))
    sharded = 0
    for key, spec in jax_runs["specs"].items():
        name, transpose = torch_name(key)
        want = tuple(reversed(spec)) if transpose and len(spec) == 2 else spec
        assert got[name] == want, (key, name, got[name], spec)
        sharded += bool(spec)
    assert set(got) == {torch_name(k)[0] for k in jax_runs["specs"]}
    # fc_q/k/v (weights and biases) and fc_o in 2 x 2 x 3 attentions, fc1/fc2 in 4 FFNs, the head
    assert sharded == 2 * 3 * 7 + 4 * 3 + 1


def test_ep_rules_shard_the_stacked_experts():
    from openviic_tpu_torch.models.encoders import Encoder

    cfg = model_config(layers=2).ENCODER
    cfg.SELF_ATTENTION.MOE_EXPERTS = 4
    encoder = Encoder(ConfigNode(cfg.to_dict()))
    specs = param_shardings(encoder, world_mesh({"expert": 4}))
    ep = {n: s for n, s in specs.items() if s}
    assert sorted(ep) == sorted(f"layers.{i}.pwff.{w}" for i in range(2)
                                for w in ("w1", "b1", "w2", "b2"))
    assert all(s[0] == "expert" and len(s) == (3 if n[-2] == "w" else 2) for n, s in ep.items())
    assert not any(param_shardings(encoder, world_mesh({"data": 4})).values())


def test_shard_state_gives_adam_moments_the_local_shapes(jax_runs):
    """The counterpart of ``test_shard_state_places_adam_moments``: each
    moment holds its parameter's shard (JAX's shard shape, transposed for a
    kernel), cut from the full-shape moments; the step count replicated."""
    want = {torch_name(k)[0]: (shape[::-1] if torch_name(k)[1] else shape)
            for k, shape in jax_runs["mu_shard_shapes"].items()}
    for rank in jax_runs["ranks"]:
        adam, mesh = rank["adam"], world_mesh({"data": 2, "model": 2})
        mesh.coords = adam["coords"]
        for name, shapes in adam["shapes"].items():
            assert shapes["exp_avg"] == shapes["exp_avg_sq"] == adam["param_shapes"][name]
            assert tuple(want[name]) == adam["param_shapes"][name], name
            cut = local_shard(adam["full_moments"][name], adam["specs"][name], mesh)
            assert torch.equal(adam["sliced_moments"][name], cut), name
        assert set(adam["step_counts"].values()) == {2.0}


def test_sharded_parameters_hold_half_the_bytes(setup, jax_runs):
    vocab, config, _, _, _ = setup
    model = build_model(ConfigNode(config.to_dict()), vocab, device="cpu", init=False)
    full = {n: p.numel() for n, p in model.named_parameters()}
    local = jax_runs["ranks"][0]["xe"]["dp2xtp2"]["local_shapes"]
    specs = jax_runs["ranks"][0]["adam"]["specs"]
    sharded = [n for n, s in specs.items() if s]
    assert 2 * sum(int(np.prod(local[n])) for n in sharded) == sum(full[n] for n in sharded)
    assert all(local[n] == tuple(p.shape) for n, p in model.named_parameters() if n not in sharded)


# ------------------------------------------------------------- XE steps


@pytest.mark.parametrize("mesh", list(XE_MESHES))
def test_sharded_xe_step_matches_jax(jax_runs, mesh):
    want_losses, want_params = jax_runs["xe"][mesh]
    members = [r for r in jax_runs["ranks"] if mesh in r["xe"]]
    assert len(members) == int(np.prod(list(XE_MESHES[mesh].values())))
    for rank in members:
        np.testing.assert_allclose(rank["xe"][mesh]["losses"], want_losses, rtol=LOSS_RTOL)
        assert_params_close(rank["xe"][mesh]["params"], want_params)
    first = members[0]["xe"][mesh]["params"]
    for rank in members[1:]:  # replicated and gathered parameters agree bit for bit
        assert all(torch.equal(first[n], rank["xe"][mesh]["params"][n]) for n in first)


def test_tp_moves_the_model_axis_bytes(jax_runs):
    moved = jax_runs["ranks"][0]["xe"]["dp2xtp2"]["moved"]
    assert moved["model"]["all_reduce"] > 0 and moved["data"] == {}
    assert jax_runs["ranks"][0]["xe"]["dp4"]["moved"]["data"] == {}


# ------------------------------------------------------------- decode


def test_tp_decode_tokens_equal_jax(jax_runs):
    want_tokens, want_lp = jax_runs["decode"]
    for rank in jax_runs["ranks"][:2]:
        np.testing.assert_array_equal(rank["decode"]["tokens"].numpy(), want_tokens)
        np.testing.assert_allclose(rank["decode"]["logprobs"].numpy(), want_lp, atol=1e-5)


def test_tp_head_kernel_decode_equals_one_process(setup, jax_runs):
    vocab, config, _, flat, decode_feats = setup
    model = load_jax_params(build_model(ConfigNode(config.to_dict()), vocab, device="cpu"), flat)
    tokens, logprobs = beam_search(model, {"region_features": torch.from_numpy(decode_feats)},
                                   beam_size=BEAM, head_kernel=1)
    for rank in jax_runs["ranks"][:2]:
        assert torch.equal(rank["decode"]["kernel_tokens"], tokens)
        torch.testing.assert_close(rank["decode"]["kernel_logprobs"], logprobs, rtol=0,
                                   atol=1e-5)


def test_tp_decode_refuses_the_layer_and_beam_select_kernels(setup, jax_runs, monkeypatch):
    """Neither flag is refused under the axis any more (JAX never refused
    them): ``resident_kernel`` runs the whole layer on every rank from its
    weights gathered, ``attn_kernel`` the beam-select kernel on the rank's
    head.  ``attn_kernel``'s decode holds ``tests/torch_port_families.py``'s
    bars against JAX's under the flag from its {model 2} shards and against
    one process's.  ``resident_kernel``'s first layer call on each rank is
    held to JAX's kernel on its inputs (``check_resident_call``) and its
    decode to one process's; not to JAX's decode, from which the port's
    one-process decode already departs at these weights: on the third
    image the kernels' bf16 roundings (each call within 2 bf16 ulps of
    JAX's) flip which captions stay in the beam at a later step."""
    from tests.torch_port_families import (
        BEAM_ATOL, RESIDENT_ATOL, check_resident_call, eager_resident_kernel)

    eager_resident_kernel(monkeypatch)

    vocab, config, _, flat, decode_feats = setup
    model = load_jax_params(build_model(ConfigNode(config.to_dict()), vocab, device="cpu"), flat)
    feats = {"region_features": torch.from_numpy(decode_feats)}
    for rank in jax_runs["ranks"][:2]:
        for flag in ("resident_kernel", "attn_kernel"):
            tokens, logprobs = beam_search(model, feats, beam_size=BEAM, **{flag: True})
            got_tokens, got_lp = rank["flags"][flag]
            if flag == "resident_kernel":  # bf16 roundings inside the kernel
                calls = rank["flag_calls"][flag]
                assert calls["n_heads"] == {2} and calls["resident_layer_step"] > 0
                check_resident_call(*calls["first_resident"])
                assert torch.equal(got_tokens, tokens)
                torch.testing.assert_close(got_lp, logprobs, rtol=0, atol=RESIDENT_ATOL)
            else:
                want_tokens, want_lp = (a.reshape(got_tokens.shape)
                                        for a in jax_runs["attn_kernel_decode"])
                np.testing.assert_array_equal(got_tokens.numpy(), want_tokens)
                np.testing.assert_allclose(got_lp.numpy(), want_lp, atol=BEAM_ATOL, rtol=0)
                assert torch.equal(got_tokens, tokens)
                torch.testing.assert_close(got_lp, logprobs, rtol=0, atol=BEAM_ATOL)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_shard_merge_equals_the_full_head_with_a_tie_across_the_boundary(k):
    """Each shard's top-k (the head kernel's plain version) merged by value
    and id equals the full head's, ties at the boundary to the lower id."""
    rng = np.random.default_rng(k)
    V, D, N, shards = 64, 16, 5, 2
    x = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(V, D)).astype(np.float32))
    w[V // 2 - 1] = w[V // 2] = w[3] = 4 * x[0] / x[0].norm()  # the top logit, 3 times
    w[V // 2 - 2] = w[V // 2 + 1] = w[0]  # a tie across the boundary, lower down
    want = head_topk_reference(x, w, k)
    parts = [head_topk_reference(x, w[s * V // shards:(s + 1) * V // shards], k)
             for s in range(shards)]
    vals = torch.cat([p[0] for p in parts], dim=1)
    ids = torch.cat([p[1].long() + s * V // shards for s, p in enumerate(parts)], dim=1)
    lses = torch.stack([p[2] for p in parts], dim=1)
    got = merge_shard_topk(vals, ids, lses, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1].long())
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-6)
    if k >= 2:
        assert want[1][0, :3].tolist() == [3, V // 2 - 1, V // 2][:min(k, 3)]


# ------------------------------------------------------------- expert parallel


def test_expert_parallel_encoder_matches_replicated_jax(jax_runs):
    dense, grads = jax_runs["ep"]
    for rank in jax_runs["ranks"]:
        ep = rank["ep"]
        np.testing.assert_allclose(ep["out"].numpy(), dense, atol=EP_ATOL)
        for key, want in grads.items():
            name, transpose = torch_name(key)
            np.testing.assert_allclose(ep["grads"][name].numpy(), want.T if transpose else want,
                                       atol=EP_GRAD_ATOL, rtol=EP_GRAD_RTOL, err_msg=key)
        assert ep["local_shapes"]["layers.0.pwff.w1"][0] == 1  # 4 experts over 4 ranks
        assert ep["moved"]["expert"]["all_reduce"] > 0


# ------------------------------------------------------------- refusals


def test_tp_refuses_another_family():
    """No family is refused any more: the ORT shards as JAX's rules say,
    its attentions on one head a rank and its encoder's ``fc_gs`` (whole on
    every rank) computing the geometry of that head only."""
    from tests.test_torch_port_ort import ort_config

    vocab = make_vocab(size=VOCAB, max_len=MAX_LEN)
    model = build_model(ConfigNode(ort_config(False).to_dict()), vocab, device="cpu",
                        init=False)
    specs = shard_model(model, world_mesh({"model": 2}))
    assert specs["encoder.fc_gs.weight"] == () and model.encoder.fc_gs.weight.shape == (2, 4)
    assert model.encoder.head_parallel is not None
    attention = model.encoder.layers[0].mhatt.attention
    assert attention.h == 1 and attention.head_parallel is not None
    assert specs["encoder.layers.0.mhatt.attention.fc_q.weight"] == ("model", None)


def test_tp_refuses_indivisible_heads_where_jax_reshards(setup, jax_runs):
    """Two heads on a 4-wide model axis: the port shards as JAX does (fc_q's
    16 output columns 4 ways), gathers q, k and v to whole heads and
    multiplies its columns of the attention by its rows of fc_o; its
    losses equal JAX's at {model 4} (``test_sharded_xe_step_matches_jax``
    holds the parameters), and JAX's first loss equals its data mesh's on
    the same batch and weights."""
    vocab, config, jax_model, flat, _ = setup
    model = build_model(ConfigNode(config.to_dict()), vocab, device="cpu", init=False)
    shard_model(model, world_mesh({"model": 4}))
    attention = model.encoder.layers[0].mhatt.attention
    assert attention.h == 2 and attention.gathered_heads is not None
    assert attention.fc_q.weight.shape == (4, 16) and attention.fc_o.weight.shape == (16, 4)
    want = jax_runs["xe"]["tp4"][0]
    for rank in jax_runs["ranks"]:
        np.testing.assert_allclose(rank["xe"]["tp4"]["losses"], want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(want[0], jax_runs["xe"]["dp4"][0][0], rtol=LOSS_RTOL)


def test_indivisible_vocab_is_refused_on_both_sides(setup):
    vocab, config, _, _, _ = setup
    odd = make_vocab(size=VOCAB - 1, max_len=MAX_LEN)
    model = build_model(ConfigNode(config.to_dict()), odd, device="cpu", init=False)
    with pytest.raises(ValueError, match=r"decoder\.fc\.weight: dim 0 of size 31 not divisible "
                                         r"by mesh axis 'model' of size 2"):
        shard_model(model, world_mesh({"model": 2}))
    mesh = jax_make_mesh({"model": 2}, jax.devices()[:2])
    with pytest.raises(ValueError, match="divisible by 2"):
        jax.device_put(jnp.zeros((16, VOCAB - 1)), jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(None, "model")))


def test_make_mesh_lays_out_named_axes_and_refuses_in_jax_words():
    from openviic_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError) as jerr:
        jax_make_mesh({"data": 2, "model": 2}, jax.devices()[:3])
    with pytest.raises(ValueError) as err:
        make_mesh({"data": 2, "model": 2}, ranks=[0, 1, 2])
    assert str(err.value) == str(jerr.value)
    mesh = world_mesh({"data": 2, "model": 2}, index=2)  # rank 2 of a row-major 2 x 2
    assert mesh.coords == {"data": 1, "model": 0} and (mesh.size, mesh.rank) == (2, 1)
    one = make_mesh()  # without a group: the data axis over the one process
    assert one.shape == {"data": 1} and not one.collective
