"""The port's trainer lifecycle (``openviic_tpu_torch.training.trainer``,
``checkpoint``, the CLI) against the JAX package's ``viTrainer`` on the CPU,
and the port's resume, preemption and checkpoint contracts.

Both trainers run the tiny dataset of ``tests/conftest.py`` with the tiny
model of ``tests/helpers.py`` at dropout 0 and f32, the port's model given
the JAX trainer's initial weights.  Real scores on a tiny model may never
trigger the switch (ties count as best), so both trainers' loops see the
scripted CIDEr ``SCRIPT`` while their decodes and scores are recorded and
compared: the switch (with the best reload) comes after epoch 1, an SCST
epoch follows, and patience ends training after epoch 3."""

import json
import os
import signal
import types

import numpy as np
import pytest
import torch
from flax import traverse_util

from openviic_tpu.builders import build_trainer as build_jax_trainer
from openviic_tpu_torch.builders import build_trainer
from openviic_tpu_torch.compat.from_jax import load_jax_params
from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.training import checkpoint as ckpt
from tests.test_trainer import full_config

SCRIPT = {0: 0.5, 1: 0.4, 2: 0.6, 3: 0.3}  # val CIDEr the loop sees, by epoch
SEQ_RTOL = 2e-3  # a step sequence's losses: the JAX package's own bar (PR 10's)
SCORE_TOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """At these widths one torch thread is fastest, and keeps the file's
    cost steady beside other test processes on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def config_dict(tmp, root, dropout=0.0, **training):
    """The JAX trainer tests' config as a dict, every DROPOUT at
    ``dropout``, PATIENCE 1, a metrics row every step."""
    cfg = full_config(tmp, root).to_dict()

    def walk(node):
        if isinstance(node, dict):
            return {k: (dropout if k == "DROPOUT" else walk(v)) for k, v in node.items()}
        return node

    cfg["MODEL"] = walk(cfg["MODEL"])
    cfg["TRAINING"].update(PATIENCE=1, LOG_EVERY=1, **training)
    return cfg


def instrument(tr, rec) -> None:
    """Record what ``tr`` (either package's trainer) does, and hand its loop
    the scripted CIDEr: each phase's epoch and mean loss, val losses, every
    decode's captions, every scored eval, the XE batches."""
    real = {name: getattr(tr, name) for name in
            ("train", "train_scst", "evaluate_loss", "evaluate_metrics", "_decode_loader",
             "xe_step")}

    def train():
        rec["phases"].append((tr.epoch, "xe", real["train"]()))
        return rec["phases"][-1][2]

    def train_scst():
        rec["phases"].append((tr.epoch, "scst", real["train_scst"]()))
        return rec["phases"][-1][2]

    def evaluate_loss(loader):
        rec["val_loss"].append(real["evaluate_loss"](loader))
        return rec["val_loss"][-1]

    def evaluate_metrics(loader):
        scores = real["evaluate_metrics"](loader)
        rec["scores"].append(dict(scores))
        return dict(scores, CIDEr=SCRIPT[tr.epoch])

    def decode_loader(loader, beam):
        caps = []
        rec["decodes"].append(caps)
        for it, items, gen in real["_decode_loader"](loader, beam):
            caps.extend(gen)
            yield it, items, gen

    def xe_step(state, batch):
        rec["xe_batches"].append({k: np.asarray(batch[k]) for k in
                                  ("caption_tokens", "region_features")})
        return real["xe_step"](state, batch)

    tr.train, tr.train_scst, tr.evaluate_loss = train, train_scst, evaluate_loss
    tr.evaluate_metrics, tr._decode_loader, tr.xe_step = (evaluate_metrics, decode_loader,
                                                          xe_step)


def new_record():
    return {k: [] for k in ("phases", "val_loss", "scores", "decodes", "xe_batches")}


def lifecycle(tr):
    rec = new_record()
    instrument(tr, rec)
    tr.start(max_epochs=4)
    rec["exit_epoch"] = tr.epoch
    tr.get_predictions()
    with open(os.path.join(tr.checkpoint_path, "test_results.json")) as f:
        rec["test_results"] = json.load(f)
    return rec


def parity_config(tmp, root):
    """Batches of 2 captions and a short warmup, so that the few XE steps
    move the model far enough for its SCST samples to earn rewards that
    differ within an image."""
    cfg = config_dict(tmp, root, WARMUP=4)
    cfg["DATASET"]["FEATURE_BATCH_SIZE"] = 2
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory, tiny_dataset_dir):
    """One JAX lifecycle and the port's from the same initial weights."""
    from openviic_tpu.config import ConfigNode as JaxConfigNode

    jax_tmp, port_tmp = tmp_path_factory.mktemp("jax_run"), tmp_path_factory.mktemp("port_run")
    jax_tr = build_jax_trainer(JaxConfigNode(parity_config(jax_tmp, tiny_dataset_dir)))
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax_tr.state["params"], sep="/").items()}
    port_tr = build_trainer(ConfigNode(parity_config(port_tmp, tiny_dataset_dir)), device="cpu")
    load_jax_params(port_tr.model, flat)
    jax_rec, port_rec = lifecycle(jax_tr), lifecycle(port_tr)
    return jax_rec, port_rec, jax_tr, port_tr


def test_vocab_and_streams_equal_jax(runs):
    """The vocab each trainer built, and the XE batches it trained on (the
    JAX constructor spends one shuffle on its init template; the port
    advances its counter the same)."""
    jax_rec, port_rec, jax_tr, port_tr = runs
    assert port_tr.vocab.itos == jax_tr.vocab.itos
    assert port_tr.vocab.max_caption_length == jax_tr.vocab.max_caption_length
    assert len(port_rec["xe_batches"]) == len(jax_rec["xe_batches"]) == 8
    for got, want in zip(port_rec["xe_batches"], jax_rec["xe_batches"]):
        np.testing.assert_array_equal(got["caption_tokens"], want["caption_tokens"])
        np.testing.assert_array_equal(got["region_features"], want["region_features"])


def test_phases_switch_and_exit_equal_jax(runs):
    """The epoch of the switch and of the exit, and each epoch's mean XE
    and SCST loss within SEQ_RTOL."""
    jax_rec, port_rec, _, _ = runs
    assert [p[:2] for p in port_rec["phases"]] == [p[:2] for p in jax_rec["phases"]] == [
        (0, "xe"), (1, "xe"), (2, "scst"), (3, "scst")]
    assert port_rec["exit_epoch"] == jax_rec["exit_epoch"] == 3
    for (_, phase, got), (_, _, want) in zip(port_rec["phases"], jax_rec["phases"]):
        assert np.isfinite(got) and abs(got - want) <= SEQ_RTOL * abs(want), (phase, got, want)


def test_val_losses_equal_jax(runs):
    jax_rec, port_rec, _, _ = runs
    np.testing.assert_allclose(port_rec["val_loss"], jax_rec["val_loss"], rtol=SEQ_RTOL)


def test_captions_and_scores_equal_jax(runs):
    """Every val decode and the test predictions token-equal to JAX's, and
    every score within SCORE_TOL."""
    jax_rec, port_rec, _, _ = runs
    assert len(port_rec["decodes"]) == len(jax_rec["decodes"]) == 5
    assert port_rec["decodes"] == jax_rec["decodes"]
    assert len(port_rec["scores"]) == len(jax_rec["scores"]) == 4
    for got, want in zip(port_rec["scores"], jax_rec["scores"]):
        assert got.keys() == want.keys()
        for k in want:
            assert abs(got[k] - want[k]) <= SCORE_TOL, (k, got[k], want[k])


def test_test_results_equal_jax(runs):
    jax_rec, port_rec, _, _ = runs
    got, want = port_rec["test_results"], jax_rec["test_results"]
    assert [r["gens"] for r in got["results"]] == [r["gens"] for r in want["results"]]
    assert [r["image_id"] for r in got["results"]] == [r["image_id"] for r in want["results"]]
    assert abs(got["CIDEr"] - want["CIDEr"]) <= SCORE_TOL


# ---------------------------------------------------------------- port only
def port_config(tmp, root, **training):
    """Dropout 0.1, SCST sampling with dropout active, a bf16 decode (its
    shadow) and its guard."""
    return ConfigNode(config_dict(tmp, root, dropout=0.1, SCST_SAMPLE_DROPOUT=True,
                                  DECODE_DTYPE="bfloat16", **training))


def scripted(tr):
    real = tr.evaluate_metrics
    tr.evaluate_metrics = lambda loader: dict(real(loader), CIDEr=SCRIPT[tr.epoch])
    return tr


def metric_rows(tr):
    """metrics.jsonl's training rows without their clock-dependent fields
    (the guard logs once per trainer, so a resumed run logs it again)."""
    with open(os.path.join(tr.checkpoint_path, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k not in ("time", "train/captions_per_sec")}
            for r in rows if not any(k.startswith("decode_dtype_guard/") for k in r)]


def params_of(tr):
    return {n: p.detach().clone() for n, p in tr.model.named_parameters()}


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory, tiny_dataset_dir):
    tmp = tmp_path_factory.mktemp("port_u")
    tr = scripted(build_trainer(port_config(tmp, tiny_dataset_dir), device="cpu"))
    tr.start(max_epochs=4)
    return tr


@pytest.mark.parametrize("cuts", [(2,), (2, 1), (3,)],
                         ids=["across-switch", "switch-then-mid-scst", "mid-scst"])
def test_resume_is_bit_identical(uninterrupted, tmp_path_factory, tiny_dataset_dir, cuts):
    """Runs cut after ``cuts`` epochs and resumed by fresh trainers end
    with the uninterrupted run's parameters, RL Adam moments, generator,
    loader counters and metrics rows, bit for bit (dropout 0.1, SCST
    sampling with dropout)."""
    tmp = tmp_path_factory.mktemp("port_r")
    cfg = port_config(tmp, tiny_dataset_dir)
    done = 0
    for n in cuts:
        tr = scripted(build_trainer(cfg, device="cpu"))
        tr.start(max_epochs=n)
        done += n
    tr = scripted(build_trainer(cfg, device="cpu"))
    tr.start(max_epochs=4 - done)
    u = uninterrupted
    assert tr.epoch == u.epoch == 3 and tr.use_rl and u.use_rl
    for name, p in params_of(u).items():
        assert torch.equal(params_of(tr)[name], p), name
    got, want = tr.state["optimizer"].state_dict(), u.state["optimizer"].state_dict()
    assert got["state"].keys() == want["state"].keys() and want["state"]
    for i, entry in want["state"].items():
        for k, v in entry.items():
            assert torch.equal(got["state"][i][k], v), (i, k)
    assert torch.equal(tr.state["generator"].get_state(), u.state["generator"].get_state())
    assert tr.state["step"] == u.state["step"]
    assert (tr.train_dataloader.epoch, tr.train_dict_dataloader.epoch) == (
        u.train_dataloader.epoch, u.train_dict_dataloader.epoch)
    assert metric_rows(tr) == metric_rows(u)


def test_mid_scst_checkpoint_round_trip(uninterrupted, tiny_dataset_dir):
    """The last checkpoint (after an SCST epoch) loaded into a fresh
    trainer: parameters, RL Adam, generator and loader counters equal; the
    decode's bf16 shadow is recast after the load."""
    u = uninterrupted
    tr = build_trainer(u.config, device="cpu")
    shadow = tr.beam_searcher.shadow
    batch = {k: torch.from_numpy(v) for k, v in next(iter(tr.val_dict_dataloader)).arrays().items()}
    tr.beam_searcher(batch, 2)
    casts = shadow.casts
    loaded = tr.load_checkpoint(os.path.join(tr.checkpoint_path, ckpt.LAST_NAME))
    assert loaded["use_rl"] and loaded["epoch"] == 3
    tr._restore_loader_epochs(loaded, True)
    tr._ensure_scst(reset_opt=False)
    for name, p in params_of(u).items():
        assert torch.equal(params_of(tr)[name], p), name
    got, want = tr.state["optimizer"].state_dict(), u.state["optimizer"].state_dict()
    for i, entry in want["state"].items():
        for k, v in entry.items():
            assert torch.equal(got["state"][i][k], v), (i, k)
    assert got["param_groups"][0]["betas"] == (0.9, 0.999)
    assert torch.equal(tr.state["generator"].get_state(), u.state["generator"].get_state())
    assert (tr.train_dataloader.epoch, tr.train_dict_dataloader.epoch) == (
        u.train_dataloader.epoch, u.train_dict_dataloader.epoch)
    tr.beam_searcher(batch, 2)
    assert shadow.casts == casts + 1


def test_best_reload_refreshes_the_bf16_shadow(tmp_path_factory, tiny_dataset_dir):
    """The switch's best reload copies weights into the live parameters, so
    the decode's bf16 shadow is recast before the next decode."""
    tmp = tmp_path_factory.mktemp("port_shadow")
    tr = scripted(build_trainer(port_config(tmp, tiny_dataset_dir), device="cpu"))
    tr.start(max_epochs=1)  # epoch 0 is best: best_model written
    batch = {k: torch.from_numpy(v) for k, v in next(iter(tr.val_dict_dataloader)).arrays().items()}
    shadow = tr.beam_searcher.shadow
    tr.beam_searcher(batch, 2)
    casts = shadow.casts
    best = params_of(tr)
    tr.train()  # the weights move
    tr.beam_searcher(batch, 2)
    assert shadow.casts == casts + 1
    tr.load_checkpoint(os.path.join(tr.checkpoint_path, ckpt.BEST_NAME))
    for name, p in best.items():
        assert torch.equal(params_of(tr)[name], p), name
    tr.beam_searcher(batch, 2)
    assert shadow.casts == casts + 2
    assert all(torch.equal(s, p.to(s.dtype)) for s, p in
               zip(shadow.model.parameters(), tr.model.parameters()))


def test_sigterm_checkpoints_and_restores_handlers(tmp_path_factory, tiny_dataset_dir):
    """SIGTERM in an epoch: the epoch finishes, its checkpoint is written,
    the loop ends and the handlers are restored; a resume continues."""
    tmp = tmp_path_factory.mktemp("port_sigterm")
    cfg = ConfigNode(config_dict(tmp, tiny_dataset_dir))
    tr = build_trainer(cfg, device="cpu")
    real = tr.train

    def train_and_signal():
        out = real()
        os.kill(os.getpid(), signal.SIGTERM)
        return out

    tr.train = train_and_signal
    before = signal.getsignal(signal.SIGTERM)
    tr.start(max_epochs=5)
    assert tr.epoch == 0
    assert signal.getsignal(signal.SIGTERM) == before
    loaded = ckpt.load_checkpoint(os.path.join(tr.checkpoint_path, ckpt.LAST_NAME))
    assert loaded["epoch"] == 0
    tr2 = build_trainer(cfg, device="cpu")
    tr2.start(max_epochs=1)
    assert tr2.epoch == 2


def test_checkpoint_across_phase_switch(tmp_path_factory, tiny_dataset_dir):
    """An XE checkpoint loads into a trainer in SCST, and an SCST one into a
    fresh trainer (in XE), whose mid-SCST resume keeps the RL Adam; both
    the XE and the RL optimizer states round-trip."""
    tmp = tmp_path_factory.mktemp("port_phase")
    cfg = ConfigNode(config_dict(tmp, tiny_dataset_dir))
    tr = build_trainer(cfg, device="cpu")
    tr.train()
    xe_moments = {k: v.clone() for k, v in tr.state["optimizer"].state_dict()["state"][0].items()}
    tr.save_checkpoint({"val_loss": 1.0, "best_val_score": 0.1, "patience": 0, "use_rl": False})
    last = os.path.join(tr.checkpoint_path, ckpt.LAST_NAME)
    tr._ensure_scst()
    loaded = tr.load_checkpoint(last)
    assert loaded is not None and loaded["use_rl"] is False
    got = tr.state["optimizer"].state_dict()["state"][0]
    assert all(torch.equal(got[k], v) for k, v in xe_moments.items())
    assert tr.state["scheduler"].last_epoch == tr.state["step"] == 2

    tr.scst_setup = None
    tr._ensure_scst()
    tr.train_scst()
    rl_moments = {k: v.clone() for k, v in tr.state["optimizer"].state_dict()["state"][0].items()}
    tr.save_checkpoint({"val_loss": 1.0, "best_val_score": 0.1, "patience": 0, "use_rl": True})
    tr2 = build_trainer(cfg, device="cpu")
    loaded2 = tr2.load_checkpoint(last)
    assert loaded2["use_rl"] is True
    tr2._ensure_scst(reset_opt=False)
    got = tr2.state["optimizer"].state_dict()
    assert got["param_groups"][0]["betas"] == (0.9, 0.999) and tr2.state["scheduler"] is None
    assert all(torch.equal(got["state"][0][k], v) for k, v in rl_moments.items())
    assert np.isfinite(tr2.train_scst())


def test_checkpoint_without_optimizer_state_fast_forwards(tmp_path_factory, tiny_dataset_dir):
    """A checkpoint with no optimizer state: fresh moments, and the Noam
    schedule resumed at the saved step, not at its warmup's start; an
    optimizer state that does not fit is reinitialised the same way."""
    tmp = tmp_path_factory.mktemp("port_noopt")
    tr = build_trainer(ConfigNode(config_dict(tmp, tiny_dataset_dir)), device="cpu")
    tr.train()
    path = os.path.join(tr.checkpoint_path, ckpt.LAST_NAME)
    state = dict(tr.state, optimizer=None, scheduler=None, step=37)
    ckpt.save_checkpoint(path, tr.model, state, {"epoch": 0, "use_rl": False})
    tr.load_checkpoint(path)
    opt, sched = tr.state["optimizer"], tr.state["scheduler"]
    assert not opt.state and sched.last_epoch == 37
    assert opt.param_groups[0]["lr"] == pytest.approx(tr.lr_schedule(37), rel=1e-12)

    rl = torch.optim.Adam(tr.model.parameters(), lr=1e-3, betas=(0.5, 0.5))
    rl.zero_grad()
    sum(p.sum() for p in tr.model.parameters()).backward()
    rl.step()
    ckpt.save_checkpoint(path, tr.model, dict(tr.state, optimizer=rl, step=41),
                         {"epoch": 0, "use_rl": False})
    tr.load_checkpoint(path)
    assert not tr.state["optimizer"].state and tr.state["scheduler"].last_epoch == 41


def test_foreign_checkpoint_refused(tmp_path, tiny_dataset_dir):
    """A JAX package checkpoint, a pickle and a torch file that is not the
    port's are refused with a clear error, and nothing is restored."""
    import pickle

    import jax

    from openviic_tpu.training import checkpoint as jax_ckpt

    jax_file = tmp_path / "jax.ckpt"
    jax_ckpt.save_checkpoint(str(jax_file), {"params": {"w": np.ones(3, np.float32)},
                                             "opt_state": (), "step": 3,
                                             "rng": jax.random.PRNGKey(0)}, {"epoch": 0})
    other = tmp_path / "other.pt"
    torch.save({"model": {}}, other)
    evil = tmp_path / "evil.pkl"
    with open(evil, "wb") as f:
        pickle.dump({"format": ckpt.FORMAT, "x": np.ones(2)}, f)
    state = np.random.get_state()
    for path in (jax_file, other, evil):
        with pytest.raises(ValueError, match="not a checkpoint of openviic_tpu_torch"):
            ckpt.load_checkpoint(str(path))
        assert all(np.array_equal(a, b) for a, b in zip(np.random.get_state(), state))
    assert ckpt.load_checkpoint(str(tmp_path / "absent.ckpt")) is None
    # the port's checkpoint of another model: refused before any weight moves
    tr = build_trainer(ConfigNode(config_dict(tmp_path, tiny_dataset_dir)), device="cpu")
    other_model = torch.nn.Linear(2, 2)
    ckpt.save_checkpoint(str(other), other_model, dict(tr.state, optimizer=None),
                         {"epoch": 0, "use_rl": False})
    before = {n: p.clone() for n, p in tr.model.state_dict().items()}
    with pytest.raises(ValueError, match="another model"):
        tr.load_checkpoint(str(other))
    assert all(torch.equal(p, before[n]) for n, p in tr.model.state_dict().items())
    # the DCP backend (tests/test_torch_port_orbax_checkpoint.py) refuses a
    # directory that holds these files; an unknown backend name raises
    from openviic_tpu_torch.training.orbax_backend import OrbaxBackend

    assert isinstance(ckpt.get_backend("orbax"), OrbaxBackend)
    (tmp_path / "foreign.orbax").mkdir()
    for path in (jax_file, other, evil):
        (tmp_path / "foreign.orbax" / ".metadata").write_bytes(path.read_bytes())
        with pytest.raises(ValueError, match="not a checkpoint of openviic_tpu_torch"):
            ckpt.get_backend("orbax").load_checkpoint(str(tmp_path / "foreign.orbax"))
        assert all(np.array_equal(a, b) for a, b in zip(np.random.get_state(), state))
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        ckpt.get_backend("nope")


def test_numpy_rng_state_restored(tmp_path_factory, tiny_dataset_dir):
    tmp = tmp_path_factory.mktemp("port_nprng")
    tr = build_trainer(ConfigNode(config_dict(tmp, tiny_dataset_dir)), device="cpu")
    np.random.seed(5)
    tr.save_checkpoint({"val_loss": 1.0, "best_val_score": 0.0, "patience": 0, "use_rl": False})
    want = np.random.rand(3)
    np.random.seed(9)
    tr.load_checkpoint(os.path.join(tr.checkpoint_path, ckpt.LAST_NAME))
    np.testing.assert_array_equal(np.random.rand(3), want)


# -------------------------------------------------- the bf16 decode guard
def guarded(tmp, root, **training):
    return build_trainer(ConfigNode(config_dict(tmp, root, DECODE_DTYPE="bfloat16",
                                                **training)), device="cpu")


def test_guard_runs_by_default_with_bf16(tmp_path_factory, tiny_dataset_dir):
    tr = guarded(tmp_path_factory.mktemp("guard_on"), tiny_dataset_dir)
    assert tr._dtype_guard_enabled and tr.last_decode_dtype_guard is None
    tr.evaluate_metrics(tr.val_dict_dataloader)
    g = tr.last_decode_dtype_guard
    assert g is not None and 0.0 <= g["token_disagreement"] <= 1.0
    assert 0.0 <= g["seq_agreement"] <= 1.0 and g["tol"] == 0.02
    tr.last_decode_dtype_guard = None  # once a trainer, not once an eval
    tr.evaluate_metrics(tr.val_dict_dataloader)
    assert tr.last_decode_dtype_guard is None


def test_guard_flags_above_tolerance(tmp_path_factory, tiny_dataset_dir):
    tr = guarded(tmp_path_factory.mktemp("guard_flag"), tiny_dataset_dir,
                 DECODE_DTYPE_GUARD_TOL=-1.0)
    tr.evaluate_metrics(tr.val_dict_dataloader)
    assert tr.last_decode_dtype_guard["flagged"]
    with open(os.path.join(tr.checkpoint_path, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    guard = [r for r in rows if "decode_dtype_guard/flagged" in r]
    assert guard and guard[0]["decode_dtype_guard/flagged"] == 1.0


def test_guard_off_without_bf16_or_when_disabled(tmp_path_factory, tiny_dataset_dir):
    tr = build_trainer(ConfigNode(config_dict(tmp_path_factory.mktemp("guard_f32"),
                                              tiny_dataset_dir)), device="cpu")
    assert not tr._dtype_guard_enabled
    tr.evaluate_metrics(tr.val_dict_dataloader)
    assert tr.last_decode_dtype_guard is None
    tr = guarded(tmp_path_factory.mktemp("guard_off"), tiny_dataset_dir,
                 DECODE_DTYPE_GUARD=False)
    assert not tr._dtype_guard_enabled
    tr.evaluate_metrics(tr.val_dict_dataloader)
    assert tr.last_decode_dtype_guard is None


def test_guard_f32_reference_matches_parity_searcher(tmp_path_factory, tiny_dataset_dir):
    """The guard's f32 searcher gives a plain f32 searcher's tokens."""
    from openviic_tpu_torch.decoding import BeamSearcher

    tr = guarded(tmp_path_factory.mktemp("guard_ref"), tiny_dataset_dir)
    batch = {k: torch.from_numpy(v) for k, v in next(iter(tr.val_dict_dataloader)).arrays().items()}
    outs, _ = BeamSearcher(tr.model)(batch, tr.evaluating_beam_size)
    tr._run_decode_dtype_guard(batch, tr.evaluating_beam_size, outs)
    g = tr.last_decode_dtype_guard
    assert g["token_disagreement"] == 0.0 and g["seq_agreement"] == 1.0 and not g["flagged"]


# ------------------------------------------------ enTrainer, CLI, refusals
def test_en_trainer_ptb_pairs(tmp_path_factory, tiny_dataset_dir):
    """enTrainer PTB-tokenizes both sides as the JAX enTrainer, scores
    through it, and its SCST reward goes through the host."""
    from openviic_tpu.training.trainer import enTrainer as JaxEnTrainer

    cfg = config_dict(tmp_path_factory.mktemp("en"), tiny_dataset_dir)
    cfg["TRAINER"] = "EnTrainer"
    tr = build_trainer(ConfigNode(cfg), device="cpu")
    gts = {"0": ["A man, walking.", "Two (dogs) run!"], "1": ["it's a cat's toy"]}
    gens = {"0": ["A man walks!"], "1": "a cat, sleeping..."}
    # the JAX hook reads nothing of its trainer but an optional tokenizer
    want = JaxEnTrainer.postprocess_pairs(types.SimpleNamespace(), gts, gens)
    assert tr.postprocess_pairs(gts, gens) == want
    assert tr.postprocess_pairs(gts, gens)[1]["0"] == ["a man walks"]
    assert "CIDEr" in tr.evaluate_metrics(tr.val_dict_dataloader)
    tr._ensure_scst()
    assert tr.scst_setup.device_reward is None and tr.scst_setup.postprocess_pairs is not None
    tr.start(max_epochs=1)
    tr.get_predictions(dataset=tr.test_dict_dataset)
    with open(os.path.join(tr.checkpoint_path, "test_results.json")) as f:
        assert "CIDEr" in json.load(f)


def test_cli_trains_on_the_tiny_config(tmp_path, tiny_dataset_dir):
    from openviic_tpu_torch.train import main

    root = str(tiny_dataset_dir)
    main(["--config-file", "configs/tiny_test.yaml", "--cpu", "--max-epochs", "1",
          "DATASET.JSON_PATH.TRAIN", f"{root}/train.json",
          "DATASET.JSON_PATH.DEV", f"{root}/dev.json",
          "DATASET.JSON_PATH.TEST", f"{root}/test.json",
          "DATASET.FEATURE_PATH.FEATURES", f"{root}/features",
          "MODEL.VISION_EMBEDDING.D_FEATURE", "13",
          "TRAINING.CHECKPOINT_PATH", str(tmp_path)])
    run = tmp_path / "tiny_transformer_region"
    for name in ("vocab.bin", "last_model.ckpt", "best_model.ckpt", "metrics.jsonl",
                 "test_results.json"):
        assert (run / name).is_file(), name
    with open(run / "test_results.json") as f:
        assert "CIDEr" in json.load(f)


def test_max_regions_pins_static_shapes(tmp_path_factory, tiny_dataset_dir):
    """DATASET.MAX_REGIONS gives every loader's region keys one row count."""
    cfg = config_dict(tmp_path_factory.mktemp("maxreg"), tiny_dataset_dir)
    cfg["DATASET"]["MAX_REGIONS"] = 48
    tr = build_trainer(ConfigNode(cfg), device="cpu")
    for loader in (tr.train_dataloader, tr.train_dict_dataloader, tr.val_dataloader,
                   tr.test_dict_dataloader):
        batch = next(iter(loader))
        assert batch["region_features"].shape[1] == batch["region_boxes"].shape[1] == 48
        assert batch["grid_features"].shape[1] == 16  # bucket-padded, not pinned


def test_entry_points_refuse_what_is_not_ported(tmp_path_factory, tiny_dataset_dir,
                                                monkeypatch):
    """Without a card the default device raises; RNG_IMPL and GRAD_ACCUM
    are checked.  The Orbax backend, refused until it was ported, now
    builds (the DCP backend); COMPILATION_CACHE_DIR, ignored until then,
    moves the kernels' build directory.  DATASET.LOADER: grain, refused
    until data parallel across processes was ported, now builds the
    host-sharded loaders (one shard in one process, the eval streams
    whole).  One process over several cards is refused, naming the
    launcher that starts one a card.  The adaptive decoder and a frozen
    backbone, refused until RSTNet was ported, now build: the backbone's
    parameters are kept out of the XE Adam."""
    from openviic_tpu_torch.data.grain_loader import GrainDataLoader
    from openviic_tpu_torch.ops import cuda_build
    from openviic_tpu_torch.training.orbax_backend import OrbaxBackend

    tmp = tmp_path_factory.mktemp("refuse")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_trainer(ConfigNode(config_dict(tmp, tiny_dataset_dir)))
    cases = [({"TRAINING": {"RNG_IMPL": "mersenne"}}, ValueError, "RNG_IMPL"),
             ({"TRAINING": {"GRAD_ACCUM": 3}}, ValueError, "GRAD_ACCUM")]
    for patch, exc, match in cases:
        cfg = config_dict(tmp, tiny_dataset_dir)
        for section, values in patch.items():
            node = cfg[section]
            for key, value in values.items():
                if isinstance(value, dict):
                    node[key].update(value)
                else:
                    node[key] = value
        with pytest.raises(exc, match=match):
            build_trainer(ConfigNode(cfg), device="cpu")
    cfg = config_dict(tmp, tiny_dataset_dir)
    cfg["DATASET"]["LOADER"] = "grain"
    tr = build_trainer(ConfigNode(cfg), device="cpu")
    assert isinstance(tr.train_dataloader, GrainDataLoader) and tr.mesh is None
    assert (tr.train_dataloader.shard_index, tr.train_dataloader.shard_count) == (0, 1)
    assert (tr.val_dict_dataloader.shard_index, tr.val_dict_dataloader.shard_count) == (0, 1)
    assert not tr.train_dataloader.drop_last and not tr.train_dict_dataloader.drop_last
    cfg = config_dict(tmp, tiny_dataset_dir, CHECKPOINT_BACKEND="orbax")
    assert isinstance(build_trainer(ConfigNode(cfg), device="cpu")._ckpt_io, OrbaxBackend)
    monkeypatch.delenv("OPENVIIC_COMPILE_CACHE", raising=False)
    cuda_build.set_build_dir(None)
    cache = tmp / "kernel_cache"
    cfg = config_dict(tmp, tiny_dataset_dir, RNG_IMPL="rbg", COMPILATION_CACHE_DIR=str(cache))
    try:
        assert build_trainer(ConfigNode(cfg), device="cpu").model is not None
        assert cuda_build.build_dir() == cache and cache.is_dir()
    finally:
        cuda_build.set_build_dir(None)

    from openviic_tpu_torch.training import trainer as trainer_module

    # data parallel over more than one card in one process (batch 4 shares a
    # factor with 4 cards): one process a card, which the launcher starts
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="over 4 cards in one process.*"
                                         "python -m openviic_tpu_torch.train"):
        trainer_module._check_config(ConfigNode(cfg), torch.device("cuda"))
    cfg["TRAINING"]["DATA_PARALLEL"] = False
    trainer_module._check_config(ConfigNode(cfg), torch.device("cuda"))
    # the adaptive decoder with its frozen backbone
    from tests.torch_port_rstnet import rstnet_model

    cfg["MODEL"] = rstnet_model()
    tr = build_trainer(ConfigNode(cfg), device="cpu")
    assert tr._frozen_mask is not None and not all(tr._frozen_mask.values())
    in_adam = {id(p) for g in tr.state["optimizer"].param_groups for p in g["params"]}
    frozen = {id(p) for n, p in tr.model.named_parameters() if not tr._frozen_mask[n]}
    assert frozen and not in_adam & frozen


def test_ragged_last_batch_and_grad_accum(tmp_path_factory, tiny_dataset_dir):
    """Without GRAD_ACCUM the ragged last batch is trained (8 captions at
    batch 3: 3, 3, 2), as in the JAX trainer on one device; GRAD_ACCUM
    drops it; STEPS_PER_CALL runs the full groups through the multi-step
    call and the rest as single steps, to the same losses."""
    losses = {}
    for name, training, batch in (("ragged", {}, 3), ("accum", {"GRAD_ACCUM": 3}, 3),
                                  ("single", {}, 2), ("multi", {"STEPS_PER_CALL": 3}, 2)):
        cfg = config_dict(tmp_path_factory.mktemp(name), tiny_dataset_dir, **training)
        cfg["DATASET"]["FEATURE_BATCH_SIZE"] = batch
        tr = build_trainer(ConfigNode(cfg), device="cpu")
        calls = []
        if tr.xe_multi_step is not None:
            real_multi = tr.xe_multi_step
            tr.xe_multi_step = lambda s, bs: calls.append(len(bs)) or real_multi(s, bs)
        sizes = []
        real = tr.xe_step
        tr.xe_step = lambda s, b: sizes.append(len(b["caption_tokens"])) or real(s, b)
        losses[name] = tr.train()
        assert tr.train_dataloader.drop_last == ("GRAD_ACCUM" in training)
        if name == "ragged":
            assert sizes == [3, 3, 2] and tr.state["step"] == 3
        elif name == "accum":
            assert sizes == [3, 3] and tr.state["step"] == 2
        elif name == "multi":
            assert calls == [3] and sizes == [2] and tr.state["step"] == 4
    assert losses["multi"] == pytest.approx(losses["single"], rel=1e-6)


def test_metrics_timer_profiler_and_nan_checks(tmp_path):
    """metrics.jsonl rows, the throughput meter, a torch.profiler trace over
    steps [start, stop), and DEBUG_NANS as autograd's anomaly mode."""
    from openviic_tpu_torch.utils.logging import setup_logger
    from openviic_tpu_torch.utils.metrics import (MetricsLogger, Profiler, StepTimer,
                                                  maybe_enable_nan_checks)

    log = MetricsLogger(str(tmp_path))
    log.log(3, {"loss": 1.5, "lr": 2}, prefix="train/")
    log.close()
    with open(tmp_path / "metrics.jsonl") as f:
        row = json.loads(f.read())
    assert row["step"] == 3 and row["train/loss"] == 1.5 and row["train/lr"] == 2.0
    timer = StepTimer()
    timer.update(10)
    assert timer.rate > 0
    prof = Profiler(str(tmp_path), start_step=2, num_steps=2)
    for step in range(1, 6):
        prof.step(step)
        torch.ones(8).sum()
    assert [p.name for p in (tmp_path / "profile").iterdir()] == ["trace_2_4.json"]
    assert setup_logger() is setup_logger() and setup_logger().handlers
    before = torch.is_anomaly_enabled()
    try:
        maybe_enable_nan_checks(False)
        assert torch.is_anomaly_enabled() == before
        maybe_enable_nan_checks(True)
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(before)
