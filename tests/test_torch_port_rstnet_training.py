"""Training RSTNet in the port: the XE loss and gradients and
``scst_log_probs`` with its gradients against the JAX package at f32 on
the CPU (same weights, ``tests/torch_port_rstnet.py``, dropout 0), the
frozen backbone (no gradient, the same leaves as JAX's
``frozen_param_mask``), and the trainer at tiny widths on the tiny dataset
of ``tests/conftest.py``: Adam without the backbone, the split checkpoint
(written once, a stale file rewritten, stitched on load and by
``CaptioningPipeline``), a bit-identical resume, the XE checkpoint guard
and the SCST signal table rebuilt every iteration.

Tolerances: the XE loss 1e-5 relative and every gradient leaf within 1e-4
of its max-abs (``tests/test_torch_port_training.py``'s bars); the SCST
log-probs 2e-4 (the port's log-prob bar) and their gradients 1e-4 as the
XE ones."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from openviic_tpu.training import optim as jax_optim
from openviic_tpu.training import steps as jax_steps
from openviic_tpu_torch.builders import build_model as build_port_model
from openviic_tpu_torch.builders import build_trainer
from openviic_tpu_torch.compat.from_jax import load_jax_params, torch_name
from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.decoding import beam_search
from openviic_tpu_torch.serving import CaptioningPipeline
from openviic_tpu_torch.training import checkpoint as ckpt
from openviic_tpu_torch.training import optim, steps
from tests.test_torch_port_trainer import config_dict
from tests.torch_port_families import _xe_batch
from tests.torch_port_rstnet import (
    assert_grads_close,
    is_backbone,
    jax_batch,
    make_rstnet,
    rstnet_model,
    torch_batch,
)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
LP_TOL = 2e-4
BEAM = 3
SCRIPT = {0: 0.5, 1: 0.4, 2: 0.6, 3: 0.3}  # the val CIDEr the loop sees: the switch after 1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    """Dropout 0 twins in both signal modes, the HF-family backbone."""
    return {mode: make_rstnet(True, mode, dropout=0.0) for mode in ("token", "prefix")}


def _jax_grads(m, loss_fn, *args):
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(m.jax_params, *args)
    return float(loss), {k: np.asarray(v) for k, v in
                         traverse_util.flatten_dict(grads, sep="/").items()}


@pytest.mark.parametrize("mode", ["token", "prefix"])
def test_xe_loss_and_gradients_match_jax(models, mode):
    """One f32 XE step on ragged captions: the loss and every trainable
    gradient leaf against ``jax.grad``; the backbone gets none (JAX's are
    exactly zero) and holds no Adam state after the step."""
    m = models[mode]
    batch = _xe_batch("aoa", m.vocab)

    def loss_fn(params, b):
        logits = m.jax_model.apply(params, b, raw_logits=True)
        return jax_steps.fused_nll(logits, b["shifted_right_caption_tokens"],
                                   m.vocab.padding_idx)

    want_loss, want = _jax_grads(m, loss_fn, jax_batch(batch))
    model = load_jax_params(build_port_model(ConfigNode(m.config), m.vocab, device="cpu"),
                            m.flat)
    opt, sched = optim.make_optimizer(optim.mask_frozen(model), 16, 100)
    backbone = {id(p) for p in model.decoder.language_model.backbone.parameters()}
    assert backbone and not backbone & {id(p) for p in optim.mask_frozen(model)}
    before = {n: p.detach().clone() for n, p in model.named_parameters() if "backbone" in n}
    _, loss = steps.make_xe_step(model)(steps.init_xe_state(model, opt, sched), torch_batch(batch))
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    errors = assert_grads_close(model, want, GRAD_TOL)
    lm_layer = [k for k in errors if "/language_model/encoder_layer/" in k]
    assert lm_layer and any(np.abs(want[k]).max() > 0 for k in lm_layer)
    for n, p in model.named_parameters():
        if n in before:
            assert torch.equal(p, before[n]), n
    assert not any(id(p) in backbone for p in opt.state)


def test_gradients_finite_on_a_ragged_token_batch():
    """``token`` mode at dropout 0.1 on captions of every length down to
    <bos> <eos>: the <pad> rows go to the language model as <bos>, so no
    fully masked row reaches a softmax and every gradient is finite."""
    m = make_rstnet(False, "token", dropout=0.1)
    batch = _xe_batch("aoa", m.vocab, bs=5, seed=9)
    batch["caption_tokens"][4, 1:] = m.vocab.padding_idx
    batch["shifted_right_caption_tokens"][4, 1:] = m.vocab.padding_idx
    batch["shifted_right_caption_tokens"][4, 0] = m.vocab.eos_idx
    model = m.port_model.train()
    logits = model(torch_batch(batch), raw_logits=True)
    loss = steps.fused_nll(logits, torch_batch(batch)["shifted_right_caption_tokens"],
                           m.vocab.padding_idx)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.requires_grad and "proj_to_vocab" not in n}  # the unused vocab head
    bad = [n for n, g in grads.items() if g is None or not torch.isfinite(g).all()]
    assert not bad, bad
    assert not any(p.grad is not None for n, p in model.named_parameters() if "backbone" in n)
    model.eval()


def test_scst_log_probs_and_gradients_match_jax(models):
    """``scst_log_probs`` of beams the port samples (with the table), zero
    after each <eos>, and the gradients of a weighted sum of them, against
    the JAX function on the same beams."""
    m = models["token"]
    feats = {"region_features": np.random.default_rng(2).normal(size=(2, 6, 13))
             .astype(np.float32)}
    table = m.port_model.compute_language_table()
    sampled, _ = beam_search(m.port_model, torch_batch(feats), beam_size=BEAM, out_size=BEAM,
                             language_table=table)
    sampled = sampled.reshape(2 * BEAM, -1).numpy()
    rows = {"region_features": np.repeat(feats["region_features"], BEAM, axis=0)}
    weights = np.random.default_rng(3).normal(size=sampled.shape).astype(np.float32)

    def loss_fn(params, b, s):
        return (jax_steps.scst_log_probs(m.jax_model, params, b, s) * weights).sum()

    want_lp = np.asarray(jax.jit(lambda p, b, s: jax_steps.scst_log_probs(m.jax_model, p, b, s))(
        m.jax_params, jax_batch(rows), jnp.asarray(sampled)))
    want_loss, want = _jax_grads(m, loss_fn, jax_batch(rows), jnp.asarray(sampled))
    model = load_jax_params(build_port_model(ConfigNode(m.config), m.vocab, device="cpu"),
                            m.flat)
    lp = steps.scst_log_probs(model, torch_batch(rows), torch.from_numpy(sampled))
    np.testing.assert_allclose(lp.detach().numpy(), want_lp, atol=LP_TOL, rtol=0)
    (lp * torch.from_numpy(weights)).sum().backward()
    assert_grads_close(model, want, GRAD_TOL)


def test_frozen_param_mask_selects_the_jax_leaves(models):
    """The port's {name: trainable} against the JAX package's mask over the
    same tree, leaf by leaf: every backbone leaf frozen, nothing else."""
    m = models["token"]
    jax_mask = traverse_util.flatten_dict(jax_optim.frozen_param_mask(m.jax_params), sep="/")
    mask = optim.frozen_param_mask(m.port_model)
    assert {torch_name(k)[0]: v for k, v in jax_mask.items()} == mask
    frozen = {k for k, v in jax_mask.items() if not v}
    assert frozen and frozen == {k for k in jax_mask if is_backbone(k)}
    assert len(optim.mask_frozen(m.port_model)) == sum(mask.values())


# ----------------------------------------------------------------- trainer
def rstnet_trainer_config(tmp, root, **training):
    """The trainer tests' config (``tests/test_torch_port_trainer.py``) with
    the RSTNet model at dropout 0.1, a short warmup, batches of 2."""
    cfg = config_dict(tmp, root, WARMUP=4, **training)
    cfg["MODEL"] = rstnet_model(True, "token")
    cfg["DATASET"]["FEATURE_BATCH_SIZE"] = 2
    return ConfigNode(cfg)


def scripted(tr):
    real = tr.evaluate_metrics
    tr.evaluate_metrics = lambda loader: dict(real(loader), CIDEr=SCRIPT[tr.epoch])
    return tr


def table_calls(tr, record):
    """Record every signal table the trainer's model computes."""
    real = tr.model.compute_language_table

    def counted():
        table = real()
        record.append(table.clone())
        return table
    tr.model.compute_language_table = counted
    return tr


class SaveLog:
    """The paths ``torch.save`` writes in the checkpoint module."""

    def __init__(self, monkeypatch):
        self.paths = []
        real = ckpt.torch.save

        def save(obj, path, *args, **kwargs):
            self.paths.append(os.path.basename(str(path)).replace(".tmp", ""))
            return real(obj, path, *args, **kwargs)
        monkeypatch.setattr(ckpt.torch, "save", save)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory, tiny_dataset_dir):
    """Three epochs (XE, XE and the switch, SCST), then test predictions;
    the tables each SCST iteration and eval decode built, and the files
    the checkpoint module wrote."""
    mp = pytest.MonkeyPatch()
    saves = SaveLog(mp)
    tables = []
    try:
        cfg = rstnet_trainer_config(tmp_path_factory.mktemp("rstnet_u"), tiny_dataset_dir)
        tr = table_calls(scripted(build_trainer(cfg, device="cpu")), tables)
        tr.start(max_epochs=3)
        iterations = len(tr.train_dict_dataloader)
        tr.get_predictions()
    finally:
        mp.undo()
    return tr, tables, saves.paths, iterations


def test_trainer_runs_rstnet_through_the_switch(uninterrupted):
    """XE, the switch, SCST and the test predictions: Adam (XE and RL) holds
    no backbone parameter, the backbone is bit-unchanged and the layers
    around it moved."""
    tr, _, _, _ = uninterrupted
    assert tr.epoch == 3 and tr.use_rl  # three epochs run, the next one due
    backbone = {id(p) for p in tr.model.decoder.language_model.backbone.parameters()}
    groups = [p for g in tr.state["optimizer"].param_groups for p in g["params"]]
    assert backbone and not backbone & {id(p) for p in groups}
    assert not backbone & {id(p) for p in tr.state["optimizer"].state}
    fresh = dict(build_port_model(tr.config.MODEL, tr.vocab, device="cpu",
                                  seed=42).named_parameters())
    lm = "decoder.language_model."
    for n, p in tr.model.named_parameters():
        if "backbone" in n:
            assert torch.equal(p, fresh[n]), n
    for n in (lm + "proj_to_caption_model.weight", lm + "encoder_layer.pwff.fc1.weight",
              "decoder.layers.2.self_attn.attention.fc_s.weight"):
        assert not torch.equal(dict(tr.model.named_parameters())[n], fresh[n]), n
    assert os.path.isfile(os.path.join(tr.checkpoint_path, "test_results.json"))


def test_split_checkpoint_is_written_once_and_stitched(uninterrupted):
    """``frozen_params.ckpt`` written once in the run; the per-epoch file
    holds only the trainable tensors, and its load stitches the backbone
    back, equal to the live weights."""
    tr, _, saved, _ = uninterrupted
    assert saved.count(ckpt.FROZEN_NAME) == 1
    assert saved.count(ckpt.LAST_NAME) == 3
    last = os.path.join(tr.checkpoint_path, ckpt.LAST_NAME)
    raw = torch.load(last, map_location="cpu", weights_only=True)
    assert raw["frozen_file"] == ckpt.FROZEN_NAME
    assert raw["model"] and not any("backbone" in k for k in raw["model"])
    frozen = torch.load(os.path.join(tr.checkpoint_path, ckpt.FROZEN_NAME), weights_only=True)
    assert frozen["format"] == ckpt.FROZEN_FORMAT
    assert set(frozen["tensors"]) == {k for k in tr.model.state_dict() if "backbone" in k}
    loaded = ckpt.load_checkpoint(os.path.join(tr.checkpoint_path, ckpt.BEST_NAME))
    assert set(loaded["model"]) == set(tr.model.state_dict())
    for k, v in frozen["tensors"].items():
        assert torch.equal(loaded["model"][k], v) and torch.equal(tr.model.state_dict()[k], v)


def test_scst_table_is_rebuilt_every_iteration(uninterrupted):
    """One table for each SCST iteration (the layers around the backbone
    train, so each differs from the one before), and one for each eval
    decode: the three val decodes and the test predictions."""
    tr, tables, _, iterations = uninterrupted
    assert iterations >= 2
    assert len(tables) == iterations + 4
    # the val decode of epochs 0 and 1, then the SCST iterations of epoch 2
    scst = tables[2:2 + iterations]
    assert any(not torch.equal(a, b) for a, b in zip(scst, scst[1:]))
    want = tr.model.compute_language_table()
    torch.testing.assert_close(tables[-1], want, rtol=0, atol=0)


def test_resume_is_bit_identical_and_a_stale_frozen_file_is_rewritten(
        uninterrupted, tmp_path_factory, tiny_dataset_dir):
    """A run whose directory holds a stale ``frozen_params.ckpt`` (another
    backbone's tensors) rewrites it at its first save; cut after epoch 1
    and resumed by a fresh trainer, it ends with the uninterrupted run's
    parameters, Adam moments and generator, bit for bit."""
    u = uninterrupted[0]
    cfg = rstnet_trainer_config(tmp_path_factory.mktemp("rstnet_r"), tiny_dataset_dir)
    run = os.path.join(cfg.TRAINING.CHECKPOINT_PATH, cfg.MODEL.NAME)
    os.makedirs(run)
    stale = {k: torch.zeros_like(v) for k, v in u.model.state_dict().items() if "backbone" in k}
    torch.save({"format": ckpt.FROZEN_FORMAT, "tensors": stale},
               os.path.join(run, ckpt.FROZEN_NAME))
    scripted(build_trainer(cfg, device="cpu")).start(max_epochs=2)
    frozen = torch.load(os.path.join(run, ckpt.FROZEN_NAME), weights_only=True)["tensors"]
    assert all(torch.equal(v, u.model.state_dict()[k]) for k, v in frozen.items())
    tr = scripted(build_trainer(cfg, device="cpu"))
    tr.start(max_epochs=1)
    assert tr.epoch == u.epoch and tr.use_rl
    for (n, p), q in zip(tr.model.named_parameters(), u.model.parameters()):
        assert torch.equal(p, q), n
    got, want = tr.state["optimizer"].state_dict(), u.state["optimizer"].state_dict()
    assert got["state"].keys() == want["state"].keys() and want["state"]
    for i, entry in want["state"].items():
        for k, v in entry.items():
            assert torch.equal(got["state"][i][k], v), (i, k)
    assert torch.equal(tr.state["generator"].get_state(), u.state["generator"].get_state())


def test_xe_checkpoint_without_the_mask_reinitialises_adam(tmp_path, tiny_dataset_dir):
    """An XE checkpoint whose Adam covers the backbone (written before the
    mask) does not fit the masked optimizer: fresh moments, the schedule
    fast-forwarded to its step."""
    tr = build_trainer(rstnet_trainer_config(tmp_path, tiny_dataset_dir), device="cpu")
    opt, sched = optim.make_optimizer(tr.model.parameters(), 16, 4)
    path = str(tmp_path / "unmasked.ckpt")
    ckpt.save_checkpoint(path, tr.model, {"optimizer": opt, "scheduler": sched, "step": 7,
                                          "generator": torch.Generator()},
                         {"use_rl": False, "epoch": 0})
    tr.load_checkpoint(path)
    assert not tr.state["optimizer"].state and tr.state["scheduler"].last_epoch == 7
    n_trainable = sum(optim.frozen_param_mask(tr.model).values())
    assert len(tr.state["optimizer"].param_groups[0]["params"]) == n_trainable


def test_pipeline_serves_the_split_checkpoint(uninterrupted):
    """``CaptioningPipeline(config, checkpoint_dir=...)`` stitches the best
    checkpoint and its frozen file, builds the table once, and captions
    the test images as the trainer's model decodes them."""
    tr = uninterrupted[0]
    config = ConfigNode({"MODEL": tr.config.MODEL.to_dict(),
                         "TRAINING": tr.config.TRAINING.to_dict()})
    pipe = CaptioningPipeline(config, checkpoint_dir=tr.checkpoint_path, use_bf16=False,
                              batch_size=4, device="cpu")
    best = ckpt.load_checkpoint(os.path.join(tr.checkpoint_path, ckpt.BEST_NAME))["model"]
    for k, v in pipe.model.state_dict().items():
        assert torch.equal(v, best[k]), k
    assert pipe.language_table.shape == (len(tr.vocab), 16)
    items = next(iter(tr.val_dict_dataloader))
    images = [{"region_features": f} for f in items["region_features"]]
    assert len(images) == 2
    _, ids = pipe.caption_features(images, return_ids=True)
    model = build_port_model(tr.config.MODEL, tr.vocab, device="cpu")
    model.load_state_dict(best)
    want, _ = beam_search(model, pipe._batch(images), beam_size=pipe.beam_size,
                          language_table=model.compute_language_table())
    np.testing.assert_array_equal(ids, want.numpy()[:len(images)])
