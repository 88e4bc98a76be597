"""The port's data parallel across processes (``openviic_tpu_torch.parallel``,
the trainer's multi-process branches, ``CaptioningPipeline(mesh=...)``) on
the CPU, against the JAX package's sharded step on a 2-device data mesh
(the 8 virtual devices of ``tests/conftest.py``).

The two-rank runs are gloo groups of two processes each
(``tests/torch_port_dp_worker.py``, and ``parallel/dryrun.py`` at tiny
widths); each runs once per module and several tests read its results."""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from openviic_tpu.builders import build_model as build_jax_model
from openviic_tpu.config import ConfigNode as JaxConfigNode
from openviic_tpu.parallel import batch_sharding, make_mesh, make_sharded_xe_step
from openviic_tpu.parallel.mesh import shard_state
from openviic_tpu_torch.compat.from_jax import torch_name
from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.parallel import dryrun, runtime
from openviic_tpu_torch.serving import CaptioningPipeline
from openviic_tpu_torch.training import steps
from openviic_tpu_torch.training import trainer as trainer_module
from tests.helpers import model_config
from tests.test_torch_port_serving import _features
from tests.test_torch_port_support import D_FEATURE as D_FEATURE_SERVING
from tests.test_torch_port_support import make_vocab, random_params
from tests.test_torch_port_trainer import config_dict
from tests.test_torch_port_training import D_FEATURE, _config, make_batch, port_model

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_port_dp_worker.py"
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-4, 1e-5  # tests/test_tensor_parallel.py's bar (under SGD)
SGD_LR = 0.05  # the same test's: an update is lr x the gradient, no Adam sign flips
XE_STEPS, GLOBAL_BS, SCST_IMAGES, SCST_BEAM = 3, 6, 4, 2
VOCAB, MAX_LEN = 150, 12
SPAWN_TIMEOUT = 240


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """At these widths one torch thread is enough, and leaves the cores to
    the ranks and to the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def start_worker(job: str, directory: Path, world: int = 2):
    """Start the worker's ``job`` in ``world`` gloo ranks (``wait_worker``
    collects them)."""
    return job, directory, dryrun.start([str(WORKER), job, str(directory)], world,
                                        str(directory))


def wait_worker(started):
    """Each rank's result of a ``start_worker`` job; a rank that fails or
    outlasts SPAWN_TIMEOUT fails the test."""
    job, directory, procs = started
    dryrun.wait(procs, str(directory), SPAWN_TIMEOUT)
    return [torch.load(directory / f"{job}_rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


# ------------------------------------------------------------- XE and SCST


@pytest.fixture(scope="module")
def setup():
    vocab = make_vocab(size=VOCAB, max_len=MAX_LEN)
    jax_model = build_jax_model(JaxConfigNode(_config()), vocab)
    flat = random_params(jax_model, vocab, seed=0, d_feature=D_FEATURE, shapes_only=True)
    return vocab, jax_model, flat


def xe_batches(vocab):
    """Global batches of 6: rows 0-2 (rank 0's) hold 18 target tokens and
    rows 3-5 (rank 1's) 25, so a mean of the ranks' means is not the loss."""
    return [make_batch(vocab, seed=10 + i, bs=GLOBAL_BS) for i in range(XE_STEPS)]


def scst_inputs(vocab):
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(SCST_IMAGES, 7, D_FEATURE)).astype(np.float32)
    feats[::2, 5:] = 0.0
    sampled = rng.integers(4, len(vocab), size=(SCST_IMAGES * SCST_BEAM, MAX_LEN))
    for i in range(len(sampled)):
        sampled[i, 2 + i % (MAX_LEN - 3)] = vocab.eos_idx
    reward = rng.uniform(0, 2, size=(SCST_IMAGES, SCST_BEAM)).astype(np.float32)
    return feats, sampled, reward


@pytest.fixture(scope="module")
def started(setup, tmp_path_factory, tiny_dataset_dir):
    """The two-rank worker jobs' inputs, and ``steps`` started on the test's
    weights and batches while JAX's side runs.  ``trainer`` runs after it
    on the tiny dataset: 2 captions a rank a step, 1 image a rank an SCST
    iteration, PATIENCE 0 (the switch after epoch 0); LABEL_SMOOTHING,
    MIXED_PRECISION and STEPS_PER_CALL set, which the sharded step
    ignores."""
    vocab, _, flat = setup
    directory = tmp_path_factory.mktemp("dp_steps")
    (directory / "job.json").write_text(json.dumps(
        {"model": _config(), "vocab": VOCAB, "max_len": MAX_LEN, "xe_steps": XE_STEPS,
         "beam": SCST_BEAM}))
    np.savez(directory / "params.npz", **flat)
    arrays = {f"xe{i}_{k}": v for i, b in enumerate(xe_batches(vocab)) for k, v in b.items()}
    feats, sampled, reward = scst_inputs(vocab)
    arrays.update(scst_region_features=feats, scst_sampled=sampled, scst_reward=reward)
    np.savez(directory / "batches.npz", **arrays)
    trainer_dir = tmp_path_factory.mktemp("dp_trainer")
    cfg = config_dict(trainer_dir, tiny_dataset_dir, LABEL_SMOOTHING=0.1,
                      MIXED_PRECISION=True, STEPS_PER_CALL=2)
    cfg["TRAINING"]["PATIENCE"] = 0
    cfg["DATASET"].update(LOADER="grain", MAX_REGIONS=8, FEATURE_BATCH_SIZE=2,
                          DICT_BATCH_SIZE=3)
    (trainer_dir / "trainer.json").write_text(json.dumps(cfg))
    return {"steps": start_worker("steps", directory), "trainer_dir": trainer_dir}


@pytest.fixture(scope="module")
def steps_run(started, jax_sharded_run):
    return wait_worker(started["steps"])


@pytest.fixture(scope="module")
def jax_sharded_run(setup):
    """JAX's ``make_sharded_xe_step`` over a 2-device data mesh under SGD."""
    vocab, jax_model, flat = setup
    mesh = make_mesh({"data": 2}, jax.devices()[:2])
    optimizer = optax.sgd(SGD_LR)
    params = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    state = shard_state({"params": params, "opt_state": optimizer.init(params),
                         "step": jnp.zeros((), jnp.int32), "rng": jax.random.PRNGKey(0)},
                        mesh, optimizer)
    step = make_sharded_xe_step(jax_model, optimizer, mesh)
    losses = []
    for batch in xe_batches(vocab):
        state, loss = step(state, jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                                                 batch_sharding(mesh)))
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in
                    traverse_util.flatten_dict(state["params"], sep="/").items()}


def assert_params_close(got: dict, want_flat: dict):
    for key, want in want_flat.items():
        name, transpose = torch_name(key)
        np.testing.assert_allclose(got[name].numpy(), want.T if transpose else want,
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=key)


def test_sharded_xe_losses_match_jax(steps_run, jax_sharded_run):
    want, _ = jax_sharded_run
    for rank in steps_run:
        np.testing.assert_allclose(rank["xe_losses"], want, rtol=LOSS_RTOL)


def test_sharded_xe_parameters_match_jax(steps_run, jax_sharded_run):
    _, want = jax_sharded_run
    assert_params_close(steps_run[0]["xe_params"], want)


def test_parameters_bit_equal_across_ranks(steps_run):
    a, b = steps_run[0], steps_run[1]
    assert a["xe_losses"] == b["xe_losses"]
    for key in ("xe_params", "scst_params"):
        assert all(torch.equal(a[key][n], b[key][n]) for n in a[key])


def test_the_loss_is_token_weighted_not_a_mean_of_rank_means(setup, jax_sharded_run):
    """The ranks' token counts differ, so the mean of the per-rank means is
    further from the global loss than the bar: the step must weight."""
    vocab, _, flat = setup
    batch = {k: torch.from_numpy(v) for k, v in xe_batches(vocab)[0].items()}
    model = port_model(vocab, flat)
    halves = [{k: v[i * 3:(i + 1) * 3] for k, v in batch.items()} for i in range(2)]
    counts = [int((h["shifted_right_caption_tokens"] != vocab.padding_idx).sum()) for h in halves]
    means = [float(steps.make_eval_loss_step(model)(h)) for h in halves]
    want = jax_sharded_run[0][0]
    assert counts[0] != counts[1]
    assert abs(np.mean(means) - want) > 10 * LOSS_RTOL * abs(want)
    weighted = sum(m * c for m, c in zip(means, counts)) / sum(counts)
    assert abs(weighted - want) <= LOSS_RTOL * abs(want)


def test_the_sharded_step_ignores_smoothing_mixed_precision_and_multi_steps(steps_run):
    """The port's side of the JAX trainer's sharded step: under data
    parallel the trainer's XE step with LABEL_SMOOTHING, MIXED_PRECISION and
    STEPS_PER_CALL set equals the one without, bit for bit, and there is no
    multi-step call."""
    for rank in steps_run:
        plain, tuned = rank["quirk"]["plain"], rank["quirk"]["tuned"]
        assert plain[0] == tuned[0] and plain[2] and tuned[2]
        assert all(torch.equal(plain[1][n], tuned[1][n]) for n in plain[1])


def test_jax_trainer_sharded_step_ignores_the_same_keys(tmp_path, tiny_dataset_dir,
                                                        monkeypatch):
    """The JAX side: its trainer on a data mesh (batch 4 over the 8 virtual
    devices) runs ``make_sharded_xe_step``, whose loss takes none of them,
    with LABEL_SMOOTHING, MIXED_PRECISION and STEPS_PER_CALL set.  (The
    model's init runs jitted here: one compile instead of one an op.)"""
    import flax.linen as nn

    from openviic_tpu.builders import build_trainer as build_jax_trainer

    init = nn.Module.init
    monkeypatch.setattr(nn.Module, "init", lambda self, rng, batch: jax.jit(
        lambda r, b: init(self, r, b))(rng, batch))
    cfg = config_dict(tmp_path, tiny_dataset_dir, LABEL_SMOOTHING=0.1, MIXED_PRECISION=True,
                      STEPS_PER_CALL=2)
    tr = build_jax_trainer(JaxConfigNode(cfg))
    assert tr.mesh is not None and tr.xe_multi_step is None
    step = tr.xe_step.__wrapped__
    assert step.__code__ is make_sharded_xe_step(tr.model, tr.optimizer, tr.mesh).__wrapped__.__code__
    assert step.__code__.co_filename.endswith(os.path.join("parallel", "mesh.py"))


def test_sharded_scst_step_matches_one_process_on_the_global_rows(setup, steps_run):
    vocab, _, flat = setup
    feats, sampled, reward = scst_inputs(vocab)
    model = port_model(vocab, flat)
    state = steps.init_xe_state(model, torch.optim.SGD(model.parameters(), lr=SGD_LR))
    state, loss = steps.make_scst_grad_step(model, SCST_BEAM)(
        state, {"region_features": torch.from_numpy(feats)}, torch.from_numpy(sampled),
        torch.from_numpy(reward))
    for rank in steps_run:
        assert abs(rank["scst_loss"] - float(loss)) <= LOSS_RTOL * abs(float(loss))
        for name, p in model.named_parameters():
            torch.testing.assert_close(rank["scst_params"][name], p.detach(), rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL)


# ------------------------------------------------------------- the runtime


def test_runtime_ranks_ran_gloo_from_torchruns_environment(steps_run):
    assert [(r["backend"], r["rank"], r["world"]) for r in steps_run] == [
        ("gloo", 0, 2), ("gloo", 1, 2)]


def test_runtime_is_a_noop_without_the_environment(monkeypatch):
    for key in runtime.TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    assert runtime.initialize_distributed("cpu") is False
    assert (runtime.process_index(), runtime.process_count()) == (0, 1)
    runtime.barrier("nothing")  # no group: returns at once
    assert runtime.broadcast_object({"a": 1}) == {"a": 1}
    assert runtime.any_across(True) and not runtime.any_across(False)


def test_runtime_starts_gloo_on_the_cpu_and_refuses_an_absent_card(tmp_path):
    assert runtime.initialize_distributed("cpu", init_method=f"file://{tmp_path / 'group'}",
                                          world_size=1, rank=0)
    try:
        assert torch.distributed.get_backend() == "gloo"
        assert (runtime.process_index(), runtime.process_count()) == (0, 1)
        assert runtime.all_gather_object(3) == [3]
    finally:
        runtime.shutdown()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            runtime.initialize_distributed("cuda", init_method="tcp://localhost:1",
                                           world_size=1, rank=0)
        assert not torch.distributed.is_initialized()


# ------------------------------------------------------------- the dry run


@pytest.fixture(scope="module")
def dryrun_summary():
    """``parallel/dryrun.py`` at its tiny default widths over 2 gloo ranks,
    under SGD so that the world-1 resume meets the parameter bar."""
    return dryrun.run(dryrun.parse(["--device", "cpu", "--threads", "1", "--optimizer",
                                    "sgd"]))


def test_dryrun_ranks_match_one_process_and_each_other(dryrun_summary):
    """It raises unless the ranks' losses and parameters are bit-equal and
    their resume is bit-identical; here also the gap to one process."""
    assert dryrun_summary["loss_rel_gap"] <= LOSS_RTOL
    assert len(dryrun_summary["ranks_ms"]) == 2


def test_dryrun_world_two_checkpoint_resumes_at_world_one(dryrun_summary):
    assert dryrun_summary["world1_resume_rel_gap"] <= LOSS_RTOL
    assert dryrun_summary["world1_resume_params_close"]


def test_dryrun_exact_at_world_one_in_process():
    """One rank in this process over gloo: bit-equal to no group at all."""
    summary = dryrun.run(dryrun.parse(["--device", "cpu", "--threads", "1", "--nprocs", "1",
                                       "--in-process", "--exact", "--steps", "4", "--save-at",
                                       "2"]))
    assert summary["losses"] == summary["single_losses"]
    assert summary["backend"] == "gloo"


def test_dryrun_takes_one_card_a_rank_and_refuses_without_one(monkeypatch):
    """By default each rank takes cuda:<LOCAL_RANK> (NCCL's one card a
    rank, as train.py maps them); an indexed card or the CPU is every
    rank's; without a card the default raises."""
    opts = dryrun.parse([])
    assert (opts.device, opts.backend) == ("cuda", None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.run(opts)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert dryrun.rank_device(opts) == torch.device("cuda", 1)
    assert dryrun.rank_device(dryrun.parse(["--device", "cuda:0"])) == torch.device("cuda", 0)
    assert dryrun.rank_device(dryrun.parse(["--device", "cpu"])) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="takes one card a rank and 1 are visible"):
        dryrun.run(opts)  # two ranks, one card: NCCL would refuse them


# ------------------------------------------------------------- the trainer


@pytest.fixture(scope="module")
def trainer_run(started, steps_run):
    # one two-rank job at a time: fewer processes beside the other test files
    return wait_worker(start_worker("trainer", started["trainer_dir"]))


def test_trainer_ranks_write_each_file_once(trainer_run):
    zero, one = trainer_run
    epochs = len(zero["U"]["decisions"])
    assert zero["U_writes"] == {"files": {"vocab.bin": 1, "test_results.json": 1},
                                "saves": epochs, "copies": len([d for d in zero["U"]["decisions"]
                                                                if d["patience"] == 0])}
    assert one["U_writes"] == {"files": {}, "saves": 0, "copies": 0}
    assert zero["U_test_results"] and one["U_test_results"]
    assert zero["metrics_file"].endswith("metrics.jsonl") and one["metrics_file"] == os.devnull


def test_trainer_ranks_take_the_same_decisions(trainer_run):
    zero, one = trainer_run
    phases = zero["U"]["phases"]
    assert phases == one["U"]["phases"] and phases[:2] == ["xe", "scst"]
    assert zero["U"]["decisions"] == one["U"]["decisions"]
    assert zero["U"]["agreed"] == one["U"]["agreed"] == [True] * len(phases)
    assert zero["U"]["digest"] == one["U"]["digest"]


def test_trainer_loaders_shard_the_train_streams_only(trainer_run):
    for rank, r in enumerate(trainer_run):
        assert r["loaders"] == {"train": (rank, 2, "GrainDataLoader", True),
                                "train_dict": (rank, 2, True), "val_dict": (0, 1)}
        assert not r["multi_step"]


def test_trainer_metrics_rows_come_from_rank_zero_once(trainer_run):
    rows = trainer_run[0]["U"]["rows"]
    steps_logged = [r["step"] for r in rows if "train/xe_loss" in r or "train/scst_loss" in r]
    assert steps_logged == sorted(set(steps_logged)) and len(steps_logged) >= 4


def test_trainer_resumed_run_equals_the_uninterrupted_one(trainer_run):
    for r in trainer_run:
        assert r["R"]["phases"] == r["U"]["phases"]
        assert r["R"]["decisions"] == r["U"]["decisions"]
        assert r["R"]["digest"] == r["U"]["digest"]
    assert trainer_run[0]["R"]["rows"] == trainer_run[0]["U"]["rows"]


# ------------------------------------------------------------- refusals


REFUSALS = [
    ({"TRAINING": {"DATA_PARALLEL": False}}, "multi-host runs require TRAINING.DATA_PARALLEL"),
    ({"TRAINING": {"GRAD_ACCUM": 2}}, "TRAINING.GRAD_ACCUM is single-device only"),
    ({"DATASET": {"LOADER": "native"}}, "requires DATASET.LOADER: grain"),
    ({"DATASET": {"MAX_REGIONS": None}}, "requires static shapes: set DATASET.MAX_REGIONS"),
]


@pytest.mark.parametrize("patch,words", REFUSALS, ids=["dp", "accum", "loader", "shapes"])
def test_jax_multiprocess_refusals_in_jax_words(tmp_path, tiny_dataset_dir, patch, words):
    cfg = config_dict(tmp_path, tiny_dataset_dir)
    cfg["DATASET"].update(LOADER="grain", MAX_REGIONS=8)
    for section, values in patch.items():
        cfg[section].update(values)
    with pytest.raises(ValueError, match=words.replace(".", "\\.")):
        trainer_module.multiprocess_refusal(ConfigNode(cfg))


@pytest.mark.parametrize("shapes", [{"PAD_SIZES": {"region_features": 8}}, {"MAX_REGIONS": 8}],
                         ids=["pad_sizes", "max_regions"])
def test_configs_that_pass_the_refusals(tmp_path, tiny_dataset_dir, shapes):
    """The grain loader and pinned shapes pass, at an odd batch too: with
    one card a process the global batch always divides the data axis, so
    JAX's global-batch refusal has no counterpart."""
    cfg = config_dict(tmp_path, tiny_dataset_dir)
    cfg["DATASET"].update(LOADER="grain", FEATURE_BATCH_SIZE=3, **shapes)
    trainer_module.multiprocess_refusal(ConfigNode(cfg))


# ------------------------------------------------------------- serving


def _seeded_pipeline(vocab, **kwargs):
    """The test width's region captioner from seeded random weights, f32,
    batch 4, the head kernel's auto gate on."""
    config = ConfigNode({"MODEL": model_config(d_feature=D_FEATURE_SERVING).to_dict(),
                         "TRAINING": {"EVALUATING_BEAM_SIZE": 3, "DECODE_HEAD_KERNEL": True}})
    return CaptioningPipeline.from_state_dict(config, vocab, batch_size=4, device="cpu",
                                              use_bf16=False, seed=5, **kwargs)


def test_pipeline_over_a_device_list_equals_the_unsharded_pipeline():
    vocab = make_vocab()
    images = _features(7, seed=3)  # a full batch of 4 and a tail of 3
    plain, meshed = _seeded_pipeline(vocab), _seeded_pipeline(vocab, mesh=["cpu", "cpu"])
    want = plain.caption_features(images, return_ids=True)
    got = meshed.caption_features(images, return_ids=True)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert len(plain._replicas) == 1 and len(meshed._replicas) == 2
    assert meshed._replicas[0][1] is meshed.searcher
    assert all(s.steps > 0 for _, s, _ in meshed._replicas)


def test_pipeline_mesh_refusals():
    vocab = make_vocab()
    with pytest.raises(ValueError, match=r"batch_size 4 not divisible by the mesh data axis "
                                         r"\(3\)"):
        _seeded_pipeline(vocab, mesh=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _seeded_pipeline(vocab, mesh="auto")
