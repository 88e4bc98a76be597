"""The port's sequence parallelism (``parallel/ring_attention.py``,
``parallel/ulysses.py``, the models' ``_ring_dispatch``) and pipeline
parallelism (``parallel/pipeline.py``) across processes on the CPU, against
the JAX package's ``ring_self_attention``, ``ulysses_self_attention``, its
encoders under the ring context and its dense encoder, on the virtual
devices of ``tests/conftest.py``.

The port's ranks come from one 4-rank gloo spawn a module
(``tests/torch_port_layouts_worker.py sp_pp``), fed the same numpy-drawn
weights and inputs as JAX; world-1 cases and refusals run in this process.
Tolerances are JAX's own tests': attention 1e-5 and its gradients 1e-4
(``tests/test_ring_attention.py``, ``tests/test_ulysses.py``), encoders
under the context 2e-5, the pipelined encoder 1e-5 and its gradients
2e-4 / 1e-4 (``tests/test_pipeline_parallel.py``)."""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from openviic_tpu.builders import build_model as build_jax_model
from openviic_tpu.parallel import make_mesh as jax_make_mesh
from openviic_tpu.parallel.ring_attention import ring_self_attention as jax_ring
from openviic_tpu.parallel.ulysses import ulysses_self_attention as jax_ulysses
from openviic_tpu_torch.compat.from_jax import torch_name
from openviic_tpu_torch.parallel import dryrun
from openviic_tpu_torch.parallel.pipeline import pipeline_apply, stack_layer_params
from openviic_tpu_torch.parallel.ring_attention import ring_attention, ring_self_attention
from openviic_tpu_torch.parallel.ulysses import ulysses_self_attention
from tests.helpers import model_config
from tests.test_pipeline_parallel import _setup as pipeline_setup
from tests.test_ring_attention import _qkv, _region_batch
from tests.test_torch_port_distributed import SPAWN_TIMEOUT, WORKER
from tests.test_torch_port_support import make_vocab, random_params
from tests.test_torch_port_tensor_expert_parallel import world_mesh

WORKER = WORKER.parent / "torch_port_layouts_worker.py"
ring_mod = importlib.import_module("openviic_tpu.parallel.ring_attention")
ATOL, GRAD_ATOL = 1e-5, 1e-4
ENCODER_ATOL = 2e-5
PP_ATOL, PP_GRAD_ATOL, PP_GRAD_RTOL = 1e-5, 2e-4, 1e-4
PP_CASES = [(4, 4, 4), (4, 4, 1), (4, 4, 8), (4, 2, 4), (8, 4, 2), (3, 1, 2)]
PP_IDS = ["p4m4", "p4m1", "p4m8", "2layers-per-stage", "l8p4", "p1"]


def _np(x):
    return {k: np.asarray(v) for k, v in x.items()}


def _flat(params):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def attention_arrays():
    """The JAX tests' inputs: (q, k, v) of seeds 0, 1, 3, 4 and 7, the bias
    of seed 2 (and 5 on the data x seq mesh), the masks."""
    out = {}
    for seed, shape in ((0, {}), (1, {}), (3, {}), (4, {"b": 4}), (7, {"n": 16})):
        q, k, v = _qkv(seed=seed, **shape)
        out.update({f"q{seed}": q, f"k{seed}": k, f"v{seed}": v})
    b, n, h = 2, 32, 4
    out["bias1"] = np.random.default_rng(2).normal(size=(b, h, n, n)).astype(np.float32)
    mask = np.zeros((b, n), bool)
    mask[:, -7:] = True  # the pad tail, across a shard boundary
    out["mask3"] = mask
    out["bias4"] = np.random.default_rng(5).normal(size=(4, h, n, n)).astype(np.float32)
    mask4 = np.zeros((4, n), bool)
    mask4[:, ::5] = True
    out["mask4"] = mask4
    return {k: np.asarray(v) for k, v in out.items()}


def encoder_configs():
    flagship = model_config()
    ort = model_config(architecture="ObjectRelationTransformer", encoder="GeometricEncoder",
                       enc_attention="AugmentedGeometryScaledDotProductAttention",
                       trignometric=False)
    ort_trig = model_config(architecture="ObjectRelationTransformer",
                            encoder="GeometricEncoder",
                            enc_attention="AugmentedGeometryScaledDotProductAttention")
    return {"flagship": flagship, "ort": ort, "ort_trig": ort_trig}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worker's four ranks, started first, and JAX's side computed while
    they run."""
    directory = tmp_path_factory.mktemp("layouts_sp_pp")
    arrays = attention_arrays()
    np.savez(directory / "sp_arrays.npz", **arrays)
    batch = _np(_region_batch())
    np.savez(directory / "sp_region_batch.npz", **batch)
    configs = encoder_configs()
    vocab = make_vocab(size=30, max_len=12)
    jax_models, params = {}, {}
    for name, config in configs.items():
        jax_models[name] = build_jax_model(config, vocab)
        two = {k: v[:2] for k, v in batch.items() if k != "caption_tokens"}
        flat = random_params(jax_models[name], vocab, seed=0, shapes_only=True, batch=two)
        params[name] = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                                                    sep="/")
        np.savez(directory / f"sp_{name}_params.npz", **flat)
    (directory / "sp_encoders.json").write_text(json.dumps(
        {"vocab": len(vocab), "max_len": vocab.max_caption_length,
         **{name: c.to_dict() for name, c in configs.items()}}))
    pp = {"cases": PP_CASES}
    pp_jax = {}
    for layers in (3, 4, 8):
        cfg, enc_params, features, padding_mask, dense = pipeline_setup(layers)
        pp[f"encoder_{layers}"] = cfg.to_dict()
        np.savez(directory / f"pp_params_{layers}.npz", **_flat(enc_params))
        pp_jax[layers] = (cfg, enc_params, np.asarray(dense))
    rng = np.random.default_rng(1)
    generic_w = (rng.normal(size=(4, 16, 16)) * 0.1).astype(np.float32)
    generic_x = rng.normal(size=(8, 16)).astype(np.float32)
    np.savez(directory / "pp_arrays.npz", features=np.asarray(features),
             padding_mask=np.asarray(padding_mask), generic_w=generic_w, generic_x=generic_x)
    (directory / "pp.json").write_text(json.dumps(pp))
    procs = dryrun.start([str(WORKER), "sp_pp", str(directory)], 4, str(directory))
    try:
        want = {}
        a = {k: jnp.asarray(v) for k, v in arrays.items()}
        seq4 = jax_make_mesh({"seq": 4}, jax.devices()[:4])
        data_seq = jax_make_mesh({"data": 2, "seq": 2}, jax.devices()[:4])
        for name, fn in (("ring", jax_ring), ("ulysses", jax_ulysses)):
            # jitted: an eager shard_map compiles at every call
            call = jax.jit(lambda q, k, v, bias=None, key_mask=None, fn=fn: fn(
                q, k, v, seq4, bias=bias, key_mask=key_mask))
            want[f"{name}_plain"] = call(a["q0"], a["k0"], a["v0"])
            want[f"{name}_bias"] = call(a["q1"], a["k1"], a["v1"], bias=a["bias1"])
            want[f"{name}_mask"] = call(a["q3"], a["k3"], a["v3"], key_mask=a["mask3"])
            want[f"{name}_grads"] = jax.jit(jax.grad(
                lambda q, k, v, fn=fn: jnp.sum(fn(q, k, v, seq4) ** 2),
                argnums=(0, 1, 2)))(a["q7"], a["k7"], a["v7"])
            want[f"{name}_data_seq"] = jax.jit(lambda q, k, v, b, m, fn=fn: fn(
                q, k, v, data_seq, bias=b, key_mask=m, batch_axis="data"))(
                a["q4"], a["k4"], a["v4"], a["bias4"], a["mask4"])
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        for name in ("flagship", "ort"):
            model = jax_models[name]
            feats, _ = jax.jit(lambda p, b, model=model: model.apply(
                p, b, method=model.encoder_forward))(params[name], jbatch)
            want[f"{name}_default"] = np.asarray(feats)
        pp_grads = jax.jit(jax.grad(lambda p: jnp.sum(
            _dense(pp_jax[4][0], p, features, padding_mask) ** 2)))(pp_jax[4][1])
        want["pp_grads"] = _flat(pp_grads)
        want["pp_dense"] = {layers: v[2] for layers, v in pp_jax.items()}
        dense = generic_x
        for i in range(4):
            dense = np.tanh(dense @ generic_w[i])
        want["generic"] = dense
        want["features"] = (np.asarray(features), np.asarray(padding_mask))
    finally:
        dryrun.wait(procs, str(directory), SPAWN_TIMEOUT)
    ranks = [torch.load(directory / f"sp_pp_rank{r}.pt", weights_only=False) for r in range(4)]
    want = {k: (np.asarray(v) if isinstance(v, jax.Array) else v) for k, v in want.items()}
    want["ort_trig"] = (jax_models["ort_trig"], params["ort_trig"], vocab)
    return want, ranks


def _dense(cfg, p, features, padding_mask):
    from openviic_tpu.models.encoders import Encoder

    return Encoder(cfg).apply({"params": p}, features, padding_mask)


# ------------------------------------------------------------- attention


@pytest.mark.parametrize("case", ["plain", "bias", "mask", "data_seq"])
@pytest.mark.parametrize("layout", ["ring", "ulysses"])
def test_sequence_parallel_attention_matches_jax(runs, layout, case):
    want, ranks = runs
    for rank in ranks:  # every rank returns the global output
        np.testing.assert_allclose(rank["attention"][f"{layout}_{case}"].numpy(),
                                   np.asarray(want[f"{layout}_{case}"]), atol=ATOL)


@pytest.mark.parametrize("layout", ["ring", "ulysses"])
def test_sequence_parallel_gradients_match_jax(runs, layout):
    want, ranks = runs
    for rank in ranks:
        for got, ref in zip(rank["attention"][f"{layout}_grads"], want[f"{layout}_grads"]):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=GRAD_ATOL)


def test_ring_body_reads_only_its_own_kv_rows(runs):
    """Each rank's K and V hold garbage outside its own sequence block: the
    output is bit-equal to the run on clean inputs."""
    _, ranks = runs
    for rank in ranks:
        assert torch.equal(rank["attention"]["ring_garbage"], rank["attention"]["ring_plain"])


def test_the_layouts_move_their_bytes(runs):
    _, ranks = runs
    moved = ranks[0]["attention"]["moved"]
    seq = moved["seq"]["seq"]
    assert seq["ring_shift"] > 0 and seq["all_to_all"] > 0 and seq["all_gather"] > 0
    assert moved["data_seq"]["data"]["all_gather"] > 0


# ------------------------------------------------------------- encoders


@pytest.mark.parametrize("name", ["flagship", "ort"])
def test_encoder_under_the_ring_context_matches_jax(runs, name):
    want, ranks = runs
    for rank in ranks:
        enc = rank["encoders"]
        np.testing.assert_allclose(enc[f"{name}_ring"].numpy(), want[f"{name}_default"],
                                   atol=ENCODER_ATOL)
        assert enc[f"{name}_ring_calls"] == 2  # one a layer


def test_encoder_under_ulysses_matches_jax(runs):
    want, ranks = runs
    for rank in ranks:
        enc = rank["encoders"]
        np.testing.assert_allclose(enc["flagship_ulysses"].numpy(), want["flagship_default"],
                                   atol=ENCODER_ATOL)
        assert enc["flagship_ulysses_calls"] == (2, 0)


def test_ulysses_falls_back_to_the_ring_on_indivisible_heads(runs):
    want, ranks = runs
    for rank in ranks:
        enc = rank["encoders"]
        np.testing.assert_allclose(enc["flagship_fallback"].numpy(), want["flagship_default"],
                                   atol=ENCODER_ATOL)
        assert enc["flagship_fallback_calls"] == (0, 2)


def test_the_geometry_kernel_flag_keeps_precedence_over_the_context(runs, monkeypatch):
    """Under ``OPENVIIC_GEO_FUSED`` the ORT's attention takes the geometry
    kernel, never ``_attend``, in both packages: the context is not
    consulted (JAX traces no ring) and the port's output is the flag's."""
    from openviic_tpu_torch.builders import build_model
    from openviic_tpu_torch.compat.from_jax import load_jax_params
    from openviic_tpu_torch.config import ConfigNode

    want, ranks = runs
    configs = encoder_configs()
    jax_model, params, vocab = want["ort_trig"]
    batch = _np(_region_batch())
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    monkeypatch.setenv("OPENVIIC_GEO_FUSED", "1")
    before = ring_mod.DISPATCH_STATS["traces"]
    with ring_mod.ring_attention(jax_make_mesh({"seq": 4}, jax.devices()[:4]), "seq"):
        jax.jit(lambda p, b: jax_model.apply(p, b, method=jax_model.encoder_forward))(
            params, jbatch)
    assert ring_mod.DISPATCH_STATS["traces"] == before
    model = build_model(ConfigNode(configs["ort_trig"].to_dict()), vocab, device="cpu")
    load_jax_params(model, _flat(params))
    with torch.no_grad():
        flag_only, _ = model.eval().encoder_forward({k: torch.from_numpy(v)
                                                     for k, v in batch.items()})
    for rank in ranks:
        assert rank["encoders"]["ort_geo_fused_ring_calls"] == 0
        torch.testing.assert_close(rank["encoders"]["ort_geo_fused"], flag_only, rtol=0, atol=0)


# ------------------------------------------------------------- refusals


def test_sequence_parallel_refusals_in_jax_words():
    jmesh = jax_make_mesh({"seq": 4}, jax.devices()[:4])
    mesh = world_mesh({"seq": 4})
    q30 = _qkv(n=30)[0]
    h6 = _qkv(h=6)[0]
    for jfn, fn, x in ((jax_ring, ring_self_attention, q30), (jax_ulysses,
                                                             ulysses_self_attention, q30),
                       (jax_ulysses, ulysses_self_attention, h6)):
        with pytest.raises(ValueError) as jerr:
            jfn(x, x, x, jmesh)
        t = torch.from_numpy(np.asarray(x))
        with pytest.raises(ValueError) as err:
            fn(t, t, t, mesh)
        assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="unknown sequence-parallel mode 'x'"):
        with ring_attention(mesh, mode="x"):
            pass


# ------------------------------------------------------------- pipeline


@pytest.mark.parametrize("layers,pipe,micro", PP_CASES, ids=PP_IDS)
def test_pipelined_encoder_matches_dense(runs, layers, pipe, micro):
    want, ranks = runs
    members = [r for r in ranks if f"l{layers}p{pipe}m{micro}" in r["pipeline"]]
    assert len(members) == pipe
    for rank in members:
        np.testing.assert_allclose(rank["pipeline"][f"l{layers}p{pipe}m{micro}"].numpy(),
                                   want["pp_dense"][layers], atol=PP_ATOL)
        # each rank holds its stage's layers only
        assert rank["pipeline"][f"l{layers}p{pipe}m{micro}_layers"] == layers // pipe


def test_pipelined_encoder_dp_pp_mesh(runs):
    want, ranks = runs
    for rank in ranks:
        np.testing.assert_allclose(rank["pipeline"]["dp_pp"].numpy(), want["pp_dense"][4],
                                   atol=PP_ATOL)


def test_pipeline_grad_matches_dense(runs):
    """Each rank's own layer's gradients (and the replicated LayerNorm's)
    equal the dense stack's."""
    want, ranks = runs
    seen = set()
    for rank in ranks:
        for name, got in rank["pipeline"]["grads"].items():
            seen.add(name)
        first, last = rank["pipeline"]["stage"]
        assert last - first == 1
    for key, ref in want["pp_grads"].items():
        name, transpose = torch_name(key)
        assert name in seen, name
        for rank in ranks:
            got = rank["pipeline"]["grads"].get(name)
            if got is not None:
                np.testing.assert_allclose(got.numpy(), ref.T if transpose else ref,
                                           atol=PP_GRAD_ATOL, rtol=PP_GRAD_RTOL, err_msg=key)


def test_pipeline_apply_generic_stage(runs):
    want, ranks = runs
    for rank in ranks:
        np.testing.assert_allclose(rank["pipeline"]["generic"].numpy(), want["generic"],
                                   atol=1e-6)
    moved = ranks[0]["pipeline"]["pipe_moved"]["pipe"]
    assert moved["pipeline_shift"] > 0


def test_pipeline_validation_errors():
    mesh = world_mesh({"pipe": 4})
    x = torch.zeros((8, 16))
    with pytest.raises(ValueError, match="not divisible into 4 pipeline"):
        pipeline_apply(lambda p, h, a: h, torch.zeros((3, 16, 16)), x, mesh=mesh,
                       microbatches=2)
    with pytest.raises(ValueError, match="not divisible into 3 microbatches"):
        pipeline_apply(lambda p, h, a: h, torch.zeros((4, 16, 16)), x, mesh=mesh,
                       microbatches=3)
    with pytest.raises(ValueError, match="microbatches must be >= 1"):
        pipeline_apply(lambda p, h, a: h, torch.zeros((4, 16, 16)), x, mesh=mesh,
                       microbatches=0)


def test_stack_layer_params():
    trees = [{"a": torch.ones(2) * i, "b": {"c": torch.zeros(3)}} for i in range(4)]
    stacked = stack_layer_params(trees)
    assert stacked["a"].shape == (4, 2)
    assert stacked["b"]["c"].shape == (4, 3)
    torch.testing.assert_close(stacked["a"][2], torch.full((2,), 2.0))
