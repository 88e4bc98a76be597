"""Importing runs of the original (PyTorch) OpenViIC into the port
(``openviic_tpu_torch/compat/torch_import.py``, ``compat/migrate.py`` and
``openviic_tpu_torch/import_reference_checkpoint.py``) against the JAX
package's importer (``openviic_tpu/compat``), with synthetic original-code
``state_dict``s: ``tests/test_torch_import.py``'s
``reference_named_state_dict`` for the flagship, and for the other
families the original's names of random JAX weights (the inverse of the
JAX importer's ``_ref_key``).  The port's imported weights equal the JAX
import's carried through ``compat.from_jax`` tensor for tensor, and the
forwards agree within 1e-5; the Adam moments equal JAX's leaf by leaf."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from openviic_tpu.builders import build_model as build_jax_model
from openviic_tpu.compat import convert_torch_state_dict as jax_convert
from openviic_tpu.compat.migrate import convert_torch_adam_state as jax_adam_state
from openviic_tpu.compat.migrate import load_reference_vocab as jax_load_reference_vocab
from openviic_tpu.compat.torch_import import _ref_key
from openviic_tpu.compat.torch_import import load_reference_checkpoint as jax_load_checkpoint
from openviic_tpu.config import ConfigNode as JaxConfigNode
from openviic_tpu_torch.builders import build_model as build_port_model
from openviic_tpu_torch.compat import migrate
from openviic_tpu_torch.compat.from_jax import state_dict_from_jax, torch_name
from openviic_tpu_torch.compat.torch_import import (
    convert_torch_state_dict,
    load_reference_checkpoint,
)
from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.data.vocab import Vocab
from openviic_tpu_torch.serving import CaptioningPipeline
from openviic_tpu_torch.training import checkpoint as ckpt
from tests.helpers import model_config
from tests.test_migrate import _reference_vocab_pickle
from tests.test_torch_import import reference_named_state_dict
from tests.test_torch_port_support import make_captions, make_features, make_vocab, random_params
from tests.torch_port_families import family_batch, family_config

ATOL = 1e-5


def _template(jax_model, batch) -> dict:
    """The JAX model's parameter tree as zeros (traced, not run)."""
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), batch)
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _flat(params) -> dict:
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def reference_state_dict_of(flat: dict) -> dict:
    """JAX parameters ``flat`` under the original code's names: the inverse
    of the JAX importer's ``_ref_key`` (kernels transposed, the fused
    ``fc_gs`` split into one Linear(d_g, 1) clone a head)."""
    sd = {}
    for key, value in flat.items():
        path = tuple(key.split("/"))
        if "fc_gs" in path:
            prefix = ".".join(s for s in path[:-1] if s not in ("params", "fc_gs")) + ".fc_gs"
            for h in range(value.shape[-1]):
                leaf = value[:, h][None] if path[-1] == "kernel" else value[h:h + 1]
                sd[f"{prefix}.{h}.{'weight' if path[-1] == 'kernel' else 'bias'}"] = leaf
            continue
        name, kind = _ref_key(path)
        sd[name] = value.T if kind == "linear_w" and value.ndim == 2 else value
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _both_imports(config: dict, vocab, sd, batch):
    """(the JAX import of ``sd`` as flat parameters, the JAX model, the
    port's model holding the port's import of ``sd``)."""
    jax_model = build_jax_model(JaxConfigNode(config), vocab)
    params, missing, unused = jax_convert(sd, _template(jax_model, batch))
    assert missing == [] and unused == []
    port = build_port_model(ConfigNode(config), vocab, device="cpu", init=False)
    weights, missing, unused = convert_torch_state_dict(sd, port)
    assert missing == [] and unused == []
    port.load_state_dict(weights, strict=True)
    want = state_dict_from_jax(_flat(params), port)
    assert weights.keys() == want.keys()
    for name in want:  # the same numbers, bit for bit
        torch.testing.assert_close(weights[name], want[name], rtol=0, atol=0, msg=name)
    return params, jax_model, port


def _assert_forwards_equal(jax_model, params, port, batch, vocab):
    want = np.asarray(jax.jit(jax_model.apply)(params, {k: jnp.asarray(v)
                                                        for k, v in batch.items()}))
    with torch.no_grad():
        got = port({k: torch.from_numpy(v).long() if v.dtype.kind == "i" else
                    torch.from_numpy(v) for k, v in batch.items()}).numpy()
    keep = batch["caption_tokens"] != vocab.padding_idx
    np.testing.assert_allclose(got[keep], want[keep], atol=ATOL, rtol=0)


def test_flagship_reference_state_dict_imports_as_in_jax():
    """``reference_named_state_dict`` (its decode buffers skipped) through
    both importers: the weights equal, the forwards within 1e-5."""
    vocab = make_vocab()
    sd = reference_named_state_dict(vocab)
    batch = {"region_features": make_features(3, seed=1),
             "caption_tokens": make_captions(vocab, 3, seed=1)}
    params, jax_model, port = _both_imports(model_config().to_dict(), vocab, sd, batch)
    _assert_forwards_equal(jax_model, params, port, batch, vocab)


@pytest.mark.parametrize("wrapped", [True, False], ids=["state_dict", "bare"])
def test_load_reference_checkpoint_equals_jax(tmp_path, wrapped):
    """A ``.pth`` from ``torch.save`` (the state_dict under ``state_dict``
    beside the trainer's keys, or alone) read by both packages'
    ``load_reference_checkpoint``: (weights, missing, unused) in JAX's
    order, the port's weights JAX's carried through ``from_jax`` bit for
    bit."""
    vocab = make_vocab()
    sd = reference_named_state_dict(vocab)
    sd["decoder.stray.weight"] = torch.zeros(2)
    path = tmp_path / "best_model.pth"
    torch.save({"state_dict": sd, "epoch": 3, "use_rl": False} if wrapped else sd, path)
    batch = {"region_features": make_features(2, seed=1),
             "caption_tokens": make_captions(vocab, 2, seed=1)}
    jax_model = build_jax_model(JaxConfigNode(model_config().to_dict()), vocab)
    params, jax_missing, jax_unused = jax_load_checkpoint(str(path),
                                                          _template(jax_model, batch))
    port = build_port_model(ConfigNode(model_config().to_dict()), vocab, device="cpu",
                            init=False)
    weights, missing, unused = load_reference_checkpoint(str(path), port)
    assert missing == jax_missing == []
    assert unused == jax_unused == ["decoder.stray.weight"]
    want = state_dict_from_jax(_flat(params), port)
    assert weights.keys() == want.keys()
    for name in want:
        torch.testing.assert_close(weights[name], want[name], rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("family", ["meshed_memory", "ort", "dlct"])
def test_meshed_and_geometric_families_import_as_in_jax(family):
    """The Meshed-Memory decoder's ``fc_alphas.<j>``, the ORT's per-head
    ``fc_gs.<h>`` clones and DLCT's ``layers_region`` / ``layers_grid``
    stacks (with its own ``fc_gs`` clones): the weights equal the JAX
    import's; the M² and ORT forwards within 1e-5."""
    vocab = make_vocab()
    if family == "ort":  # DLCT's test regions (13-d, with boxes) are the ORT's streams
        config = model_config(architecture="ObjectRelationTransformer",
                              encoder="GeometricEncoder",
                              enc_attention="AugmentedGeometryScaledDotProductAttention"
                              ).to_dict()
        streams = {k: v for k, v in family_batch("dlct", 3, seed=2).items()
                   if k.startswith("region")}
    else:
        config = family_config(family)
        streams = family_batch(family, 3, seed=2)
    batch = dict(streams, caption_tokens=make_captions(vocab, 3, seed=2))
    jax_model = build_jax_model(JaxConfigNode(config), vocab)
    flat = random_params(jax_model, vocab, 3, shapes_only=True,
                         batch={k: v[:2] for k, v in streams.items()})
    sd = reference_state_dict_of(flat)
    assert any(".fc_gs.1." in k for k in sd) == (family != "meshed_memory")
    assert any("fc_alphas.1." in k for k in sd) == (family == "meshed_memory")
    assert any(k.startswith("encoder.layers_region.0.") for k in sd) == (family == "dlct")
    params, jax_model, port = _both_imports(config, vocab, sd, batch)
    if family != "dlct":  # DLCT's JAX encoder compiles for long; its weights suffice
        _assert_forwards_equal(jax_model, params, port, batch, vocab)


def test_missing_or_unknown_keys_are_refused(tmp_path):
    """A missing weight or a key the model does not use raises ValueError
    (the original's buffers and positional table are skipped); with
    ``allow_missing`` the import goes through and reports both.  The
    JAX-weight loader ``from_jax`` still refuses any unmatched key, the
    MoE's leaves included."""
    vocab = make_vocab()
    config = ConfigNode({"MODEL": model_config().to_dict(),
                         "TRAINING": {"CHECKPOINT_PATH": str(tmp_path / "out")}})
    sd = reference_named_state_dict(vocab)
    assert "decoder.running_seq" in sd
    for name, edit in (("missing", lambda d: d.pop("decoder.fc.weight")),
                       ("unknown", lambda d: d.update({"decoder.extra.weight": torch.ones(2)}))):
        broken = dict(sd)
        edit(broken)
        run = tmp_path / name
        run.mkdir()
        torch.save({"state_dict": broken}, run / "best_model.pth")
        with pytest.raises(ValueError, match="missing weights for"):
            migrate.import_reference_checkpoint(config, str(run / "best_model.pth"),
                                                vocab=vocab, out_dir=str(run / "m"),
                                                device="cpu")
        report = migrate.import_reference_checkpoint(
            config, str(run / "best_model.pth"), vocab=vocab, out_dir=str(run / "m"),
            allow_missing=True, device="cpu")
        assert report["missing"] == (["decoder.fc.weight"] if name == "missing" else [])
        assert report["unused"] == (["decoder.extra.weight"] if name == "unknown" else [])

    from openviic_tpu.models.ffn import MoEPositionWiseFeedForward as JaxMoE
    from openviic_tpu_torch.models.ffn import MoEPositionWiseFeedForward

    node = dict(model_config().to_dict()["ENCODER"]["SELF_ATTENTION"], MOE_EXPERTS=2)
    layer = MoEPositionWiseFeedForward(ConfigNode(node))
    flat = _flat(_template(JaxMoE(JaxConfigNode(node)), jnp.zeros((1, 3, 16))))
    assert set(state_dict_from_jax(flat, layer)) == set(layer.state_dict())
    assert torch_name("params/w1") == ("w1", False)
    for extra in ("params/router/w1", "params/fc3/kernel"):
        with pytest.raises(KeyError, match="unmatched"):
            state_dict_from_jax(dict(flat, **{extra: np.zeros(1, np.float32)}), layer)
    with pytest.raises(KeyError, match="no JAX counterpart"):
        state_dict_from_jax({k: v for k, v in flat.items() if k != "params/b2"}, layer)


def test_vocab_shim_equals_jax(tmp_path):
    """The original's pickled ``Vocab`` (its class absent here) read by the
    port's shim as the port's ``Vocab``, attribute for attribute the JAX
    shim's, word vectors as numpy; the JAX package's pickle passes
    through; another global is refused."""
    path = tmp_path / "vocab.bin"
    _reference_vocab_pickle(path, with_embeddings=True)
    got, want = migrate.load_reference_vocab(str(path)), jax_load_reference_vocab(str(path))
    assert isinstance(got, Vocab)
    for key in vars(want):
        value = getattr(want, key)
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(getattr(got, key), value)
        else:
            assert getattr(got, key) == value, key
    ids = got.encode_caption(["w0", "w1", "nope"])
    np.testing.assert_array_equal(ids, want.encode_caption(["w0", "w1", "nope"]))
    assert got.decode_caption(ids[None]) == want.decode_caption(ids[None])

    with open(tmp_path / "jax.bin", "wb") as f:
        pickle.dump(want, f)
    assert migrate.load_reference_vocab(str(tmp_path / "jax.bin")).itos == want.itos
    with open(tmp_path / "evil.bin", "wb") as f:
        pickle.dump(print, f)
    with pytest.raises(pickle.UnpicklingError, match="refused global"):
        migrate.load_reference_vocab(str(tmp_path / "evil.bin"))


def reference_run(vocab, steps: int = 3, epoch: int = 2):
    """A payload shaped as the original trainer's ``save_checkpoint``: the
    reference-named weights, after ``steps`` Adam updates (betas 0.9 /
    0.98) with seeded gradients over its parameters in ``state_dict``
    order, its LambdaLR state, the phase flags and numpy's RNG state."""
    sd = reference_named_state_dict(vocab)
    params = {k: torch.nn.Parameter(v.clone()) for k, v in sd.items() if "running" not in k}
    opt = torch.optim.Adam(params.values(), lr=1e-3, betas=(0.9, 0.98))
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)
    g = torch.Generator().manual_seed(4)
    for _ in range(steps):
        for p in params.values():
            p.grad = torch.randn(p.shape, generator=g)
        opt.step()
        sched.step()
    state_dict = {k: (params[k].detach().clone() if k in params else v) for k, v in sd.items()}
    return {"state_dict": state_dict, "optimizer": opt.state_dict(),
            "scheduler": sched.state_dict(), "epoch": epoch, "use_rl": False, "patience": 1,
            "best_val_score": 0.41, "val_loss": 2.5,
            "numpy_rng_state": np.random.RandomState(9).get_state()}


def test_adam_moments_equal_jax():
    """The original's Adam moments by the port's names equal the JAX
    package's ``convert_torch_adam_state`` leaf by leaf (kernels
    transposed back), and its count."""
    vocab = make_vocab()
    payload = reference_run(vocab)
    jax_model = build_jax_model(JaxConfigNode(model_config().to_dict()), vocab)
    batch = {"region_features": make_features(2), "caption_tokens": make_captions(vocab, 2)}
    mu, nu, count = jax_adam_state(payload, _template(jax_model, batch))
    port = build_port_model(ConfigNode(model_config().to_dict()), vocab, device="cpu",
                            init=False)
    exp_avg, exp_avg_sq, step = migrate.convert_torch_adam_state(payload, port)
    assert step == count == 3
    for got, want in ((exp_avg, _flat(mu)), (exp_avg_sq, _flat(nu))):
        assert set(got) == {torch_name(k)[0] for k in want}
        for key, value in want.items():
            name, transpose = torch_name(key)
            np.testing.assert_array_equal(got[name].numpy(), value.T if transpose else value)


@pytest.fixture()
def imported_run(tmp_path, tiny_dataset_dir):
    """The tiny dataset's trainer config (the port trainer tests'), and a
    run of the original code over its vocab, imported with ``write_last``
    into the config's checkpoint directory."""
    from tests.test_torch_port_trainer import config_dict

    cfg = config_dict(tmp_path, tiny_dataset_dir)
    vocab = Vocab.from_config(ConfigNode(cfg["DATASET"]))
    run = tmp_path / "reference_run"
    run.mkdir()
    with open(run / "vocab.bin", "wb") as f:
        pickle.dump(vocab, f)
    payload = reference_run(vocab)
    torch.save(payload, run / "last_model.pth")
    return cfg, vocab, run, payload


def test_import_serves_and_resumes_training(imported_run):
    """``import_reference_checkpoint`` into the trainer's directory: the
    pipeline from there captions as the converted weights do in memory;
    ``BaseTrainer`` resumes from its ``last_model.ckpt`` with the epoch,
    the step, the moments and the schedule's position carried, and trains
    on."""
    from openviic_tpu_torch.builders import build_trainer

    cfg, vocab, run, payload = imported_run
    config = ConfigNode(cfg)
    report = migrate.import_reference_checkpoint(config, str(run / "last_model.pth"),
                                                 write_last=True, device="cpu")
    out = report["out_dir"]
    assert out == f"{cfg['TRAINING']['CHECKPOINT_PATH']}/{cfg['MODEL']['NAME']}"
    assert report["missing"] == report["unused"] == []
    assert (report["step"], report["epoch"], report["use_rl"]) == (3, 2, False)

    port = build_port_model(config.MODEL, vocab, device="cpu", init=False)
    weights, _, _ = convert_torch_state_dict(payload["state_dict"], port)
    images = [{"region_features": f} for f in make_features(3, seed=8)]
    served = CaptioningPipeline(config, use_bf16=False, device="cpu").caption_features(images)
    direct = CaptioningPipeline.from_state_dict(config, vocab, state_dict=weights,
                                                use_bf16=False, device="cpu")
    assert served == direct.caption_features(images)

    tr = build_trainer(config, device="cpu")
    assert tr.vocab.itos == vocab.itos
    loaded = tr.load_checkpoint(f"{out}/{ckpt.LAST_NAME}")
    assert (loaded["epoch"], loaded["best_val_score"], tr.state["step"]) == (2, 0.41, 3)
    named = dict(tr.model.named_parameters())
    exp_avg, _, _ = migrate.convert_torch_adam_state(payload, port)
    opt_state = tr.state["optimizer"].state
    for name, moment in exp_avg.items():
        torch.testing.assert_close(opt_state[named[name]]["exp_avg"], moment, rtol=0, atol=0)
        assert float(opt_state[named[name]]["step"]) == 3.0
    assert tr.state["scheduler"].last_epoch == 3
    torch.testing.assert_close(named["decoder.fc.weight"].detach(),
                               payload["state_dict"]["decoder.fc.weight"], rtol=0, atol=0)
    assert np.isfinite(tr.train())


def test_cli(imported_run, tmp_path, capsys):
    """``python -m openviic_tpu_torch.import_reference_checkpoint``: the
    flags of ``scripts/import_reference_checkpoint.py`` and ``--cpu``."""
    import yaml

    from openviic_tpu_torch.import_reference_checkpoint import main

    cfg, vocab, run, _ = imported_run
    config_file = tmp_path / "config.yaml"
    config_file.write_text(yaml.safe_dump(cfg))
    out = tmp_path / "imported"
    main(["--config-file", str(config_file), "--checkpoint", str(run / "last_model.pth"),
          "--vocab-bin", str(run / "vocab.bin"), "--out", str(out), "--also-last", "--cpu"])
    assert "imported ->" in capsys.readouterr().out
    assert {p.name for p in out.iterdir()} == {"vocab.bin", ckpt.BEST_NAME, ckpt.LAST_NAME}
    assert ckpt.load_checkpoint(str(out / ckpt.BEST_NAME))["epoch"] == 2
