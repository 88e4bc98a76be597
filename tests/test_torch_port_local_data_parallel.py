"""One run over a host's devices (``openviic_tpu_torch/parallel/launch.py``,
the trainer's host-local branch, ``train.py`` without ``torchrun``)
against the JAX trainer on its single-host mesh, on the CPU.

The launcher spawns two gloo ranks on ``["cpu", "cpu"]`` (once) at
``FEATURE_BATCH_SIZE`` 6; the JAX trainer runs on the conftest's 8 virtual
devices, where ``gcd(6, 8) = 2`` also makes a 2-device data mesh.  Both
start from the JAX trainer's initial weights, at dropout 0, on the tiny
dataset with a fifth train image, and train one XE epoch, then one SCST
epoch of batches of 2 images: 2, 2 and a ragged 1, which JAX runs off its
mesh and every rank runs whole.  After each epoch: the loss within 1e-5
(of itself for XE; for SCST, of the mean magnitude of its terms, which
nearly cancel), parameters bit-equal across the ranks and within 1e-5 of
JAX's (the key biases, whose exact gradient is zero, within the step
sizes of zero, and their summed gradients zero to rounding).  Then the
refusals and the one-process cases, each against the JAX trainer's own
decision: ``GRAD_ACCUM`` 2, ``DATA_PARALLEL: false``, a batch that shares
no factor with the devices; and the loaders' parts of a global batch, alone
and in a host-local trainer."""

import json
import shutil

import numpy as np
import pytest
import torch
from flax import traverse_util

from openviic_tpu.builders import build_trainer as build_jax_trainer
from openviic_tpu.config import ConfigNode as JaxConfigNode
from openviic_tpu_torch.builders import build_model
from openviic_tpu_torch.compat.from_jax import state_dict_from_jax
from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.data.vocab import load_vocab
from openviic_tpu_torch.parallel import launch
from openviic_tpu_torch.training import trainer as trainer_module
from openviic_tpu_torch.training.optim import noam_schedule
from tests.test_torch_port_trainer import config_dict
from tests.torch_port_backend_workers import epochs_rank

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
GRAD_ZERO_RTOL = 1e-6  # a zero gradient's rounding, against the largest other gradient
GLOBAL_BATCH = 6  # gcd(6, 8) = 2 devices on JAX's side, two ranks here
JAX_DEVICES = 8
RL_LEARNING_RATE = 1e-3  # SCST steps large enough for a missed batch to show
WARMUP = 100  # config_dict's
# Adam's bias-corrected |m / sqrt(v)| exceeds 1 by at most ~0.1% in its
# first few steps at betas (0.9, 0.98)
ADAM_RATIO_MAX = 1.01
SCST_BATCHES = [2, 2, 1]  # images of the five-image epoch at DICT_BATCH_SIZE 6, beam 3


def five_image_dataset(tmp, root):
    """``root`` with the dev split's image 4 (its features and captions)
    added to the train split: five train images."""
    data = tmp / "data"
    shutil.copytree(root, data)
    with open(data / "train.json") as f:
        train = json.load(f)
    with open(data / "dev.json") as f:
        dev = json.load(f)
    train["images"] += [im for im in dev["images"] if im["id"] == 4]
    train["annotations"] += [a for a in dev["annotations"] if a["image_id"] == 4]
    with open(data / "train.json", "w") as f:
        json.dump(train, f)
    return data


def local_config(tmp, root, **training) -> dict:
    cfg = config_dict(tmp, root, **{"WARMUP": WARMUP, **training})
    cfg["DATASET"].update(FEATURE_BATCH_SIZE=GLOBAL_BATCH, DICT_BATCH_SIZE=6)
    cfg["TRAINING"]["RL_LEARNING_RATE"] = RL_LEARNING_RATE
    return cfg


def flat_params(jax_tr) -> dict:
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax_tr.state["params"], sep="/").items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, tiny_dataset_dir):
    """The two ranks' results (started first, while JAX's trainer runs)
    and the JAX trainer's after one XE and one SCST epoch from the same
    weights: each epoch's loss, step count and parameters (as the port's
    state dict)."""
    tmp = tmp_path_factory.mktemp("local_dp")
    data = five_image_dataset(tmp, tiny_dataset_dir)
    cfg = local_config(tmp / "jax", data)
    jax_tr = build_jax_trainer(JaxConfigNode(cfg))
    assert jax_tr.mesh is not None and jax_tr.mesh.shape["data"] == 2
    np.savez(tmp / "init.npz", **flat_params(jax_tr))
    out = tmp / "ranks"
    out.mkdir()
    context = launch.spawn(epochs_rank, ["cpu", "cpu"],
                           args=(str(out), ConfigNode(local_config(tmp / "port", data)),
                                 str(tmp / "init.npz")), join=False)
    jax_runs = {}
    try:
        for phase, epoch in (("xe", jax_tr.train), ("scst", jax_tr.train_scst)):
            loss = epoch()
            jax_runs[phase] = {"loss": loss, "step": int(np.asarray(jax_tr.state["step"])),
                               "params": flat_params(jax_tr)}
        jax_runs["scst_sharded_steps"] = jax_tr._scst_sharded_steps
    finally:
        while not context.join():
            pass
    vocab = load_vocab(tmp / "port" / "saved_models" / cfg["MODEL"]["NAME"] / "vocab.bin")
    template = build_model(ConfigNode(cfg["MODEL"]), vocab, device="cpu", init=False)
    for phase in ("xe", "scst"):
        jax_runs[phase]["params"] = {
            k: v.numpy() for k, v in state_dict_from_jax(jax_runs[phase]["params"],
                                                          template).items()}
    ranks = []
    for r in range(2):
        with open(out / f"rank{r}.json") as f:
            result = json.load(f)
        for phase in ("xe", "scst"):
            with np.load(out / f"rank{r}_{phase}.npz") as z:
                result[phase]["params"] = {k: z[k] for k in z.files}
        ranks.append(result)
    return ranks, jax_runs, jax_tr


def test_ranks_form_the_host_local_mesh(runs):
    ranks, jax_runs, _ = runs
    for r in ranks:
        assert r["host_local"] and r["mesh"] == 2
        assert r["loader"] == "DataLoader" and r["batch"] == GLOBAL_BATCH
        assert r["parts"] == [[r["rank"], 2]] * 2 and not r["dict_drop_last"]
        for phase in ("xe", "scst"):
            assert r[phase]["step"] == jax_runs[phase]["step"], phase
    assert 0 < jax_runs["xe"]["step"] < jax_runs["scst"]["step"]


def test_losses_match_jax(runs):
    ranks, jax_runs, _ = runs
    for r in ranks:
        np.testing.assert_allclose(r["xe"]["loss"], jax_runs["xe"]["loss"], rtol=LOSS_RTOL)
    assert ranks[0]["xe"]["loss"] == ranks[1]["xe"]["loss"]


def test_scst_losses_match_jax(runs):
    """The SCST loss is a mean of advantage-weighted log-probs whose terms
    nearly cancel after one small XE step (the advantages are small), so
    its rounding scales with its terms, not with the mean: it is held
    within LOSS_RTOL of the epoch's mean |term| (each iteration's the mean
    of the ranks', which hold equal row counts)."""
    ranks, jax_runs, _ = runs
    scales = np.mean([r["scst_term_scales"] for r in ranks], axis=0)
    assert len(scales) == len(SCST_BATCHES) and scales.min() > 0
    for r in ranks:
        gap = abs(r["scst"]["loss"] - jax_runs["scst"]["loss"])
        assert gap <= LOSS_RTOL * scales.mean(), (r["scst"]["loss"], jax_runs["scst"]["loss"],
                                                  scales)
    assert ranks[0]["scst"]["loss"] == ranks[1]["scst"]["loss"]


def assert_parameters_match(ranks, jax_runs, phase, bound) -> None:
    """Every parameter of ``phase`` bit-equal across the ranks and within
    PARAM_ATOL of JAX's, but the key projections' biases: their exact
    gradient is zero (a softmax does not see a constant added to every
    score of a query), so from their zero init Adam's steps follow the sign
    of each side's rounding noise.  Those hold zero within ``bound`` (the
    step sizes taken) on both sides, and their gradient summed over the
    ranks is zero to rounding (GRAD_ZERO_RTOL of the largest other
    gradient) on each rank."""
    zero, one = ranks[0][phase]["params"], ranks[1][phase]["params"]
    want = jax_runs[phase]["params"]
    assert zero.keys() == one.keys() == want.keys()
    noise = [n for n in zero if n.endswith("fc_k.bias")]
    assert noise
    step = max(np.abs(zero[n] - want[n]).max() for n in zero if n not in noise)
    for name in zero:
        np.testing.assert_array_equal(zero[name], one[name], err_msg=name)
        if name in noise:
            assert np.abs(zero[name]).max() <= bound, name
            assert np.abs(want[name]).max() <= bound, name
        else:
            np.testing.assert_allclose(zero[name], want[name], atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"{phase} {name}")
    assert step <= PARAM_ATOL
    for r in ranks:
        peaks = r[phase]["grad_peaks"]
        largest = max(v for k, v in peaks.items() if k not in noise)
        assert largest > 0
        for name in noise:
            assert peaks[name] <= GRAD_ZERO_RTOL * largest, (phase, name, peaks[name], largest)


def xe_bound(steps: int) -> float:
    schedule = noam_schedule(16, WARMUP, 1.0)  # config_dict's D_MODEL and LEARNING_RATE
    return sum(schedule(i) for i in range(steps))


def test_parameters_bit_equal_across_ranks_and_near_jax(runs):
    ranks, jax_runs, _ = runs
    assert_parameters_match(ranks, jax_runs, "xe", xe_bound(jax_runs["xe"]["step"]))


def test_scst_parameters_bit_equal_across_ranks_and_near_jax(runs):
    ranks, jax_runs, _ = runs
    xe_steps = jax_runs["xe"]["step"]
    scst_steps = jax_runs["scst"]["step"] - xe_steps
    assert scst_steps == len(SCST_BATCHES)
    bound = xe_bound(xe_steps) + ADAM_RATIO_MAX * RL_LEARNING_RATE * scst_steps
    assert_parameters_match(ranks, jax_runs, "scst", bound)


def test_ragged_scst_batch_runs_whole_on_every_rank_as_in_jax(runs):
    """The epoch's batches of 2 images split 1 and 1 over the ranks; its
    ragged last image runs whole on both, as JAX runs it off its mesh (two
    of its three SCST steps sharded).  The ranks' images of each batch
    together are JAX's loader's batch."""
    ranks, jax_runs, jax_tr = runs
    assert jax_runs["scst_sharded_steps"] == 2
    zero, one = ranks[0]["scst_refs"], ranks[1]["scst_refs"]
    assert [len(b) for b in zero] == [len(b) for b in one] == [1, 1, 1]
    assert zero[:2] != one[:2] and zero[2] == one[2]
    loader = jax_tr.train_dict_dataloader
    loader.epoch -= 1  # the epoch just run, drawn again
    jax_batches = [[list(c) for c in items["captions"]] for items in loader]
    assert [len(b) for b in jax_batches] == SCST_BATCHES
    assert [a + b for a, b in zip(zero[:2], one[:2])] == jax_batches[:2]
    assert zero[2] == jax_batches[2]


def jax_refusal(cfg):
    """The JAX trainer's mesh for ``cfg`` on its 8 devices (None without
    one), or the ``ValueError`` it raises."""
    try:
        return build_jax_trainer(JaxConfigNode(cfg)).mesh
    except ValueError as exc:
        return exc


def test_refusals_and_one_process_cases_match_jax(tmp_path, tiny_dataset_dir, monkeypatch):
    """``GRAD_ACCUM`` 2 over a data axis raises JAX's message; with
    ``DATA_PARALLEL: false`` or a batch of 5 (gcd 1 with 8) both train in
    one process.  A trainer built in one process on a host whose cards
    would form a data axis raises, naming the launcher; a host-local group
    refuses ``DATA_PARALLEL: false`` and ``GRAD_ACCUM`` 2, and takes an
    SCST batch that its ranks do not divide."""
    cases = [({"GRAD_ACCUM": 2}, GLOBAL_BATCH), ({"DATA_PARALLEL": False}, GLOBAL_BATCH),
             ({}, 5)]
    for i, (training, batch) in enumerate(cases):
        cfg = local_config(tmp_path / f"c{i}", tiny_dataset_dir, **training)
        cfg["DATASET"]["FEATURE_BATCH_SIZE"] = batch
        want = jax_refusal(cfg)
        if isinstance(want, ValueError):
            with pytest.raises(ValueError) as got:
                launch.data_axis(ConfigNode(cfg), JAX_DEVICES)
            assert str(got.value) == str(want)
        else:
            assert want is None
            assert launch.data_axis(ConfigNode(cfg), JAX_DEVICES) == 1
    cfg = ConfigNode(local_config(tmp_path / "one", tiny_dataset_dir))
    assert launch.data_axis(cfg, 0) == launch.data_axis(cfg, 1) == 1
    assert launch.data_axis(cfg, 4) == 2 and launch.data_axis(cfg, 3) == 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="python -m openviic_tpu_torch.train"):
        trainer_module._check_config(cfg, torch.device("cuda"))
    trainer_module._check_config(cfg, torch.device("cpu"))
    for training, message in (({"DATA_PARALLEL": False}, "trains data parallel"),
                              ({"GRAD_ACCUM": 2}, "TRAINING.GRAD_ACCUM is for single-device")):
        bad = local_config(tmp_path / "bad", tiny_dataset_dir, **training)
        with pytest.raises(ValueError, match=message):
            trainer_module.host_local_refusal(ConfigNode(bad), 2)
    odd = local_config(tmp_path / "odd", tiny_dataset_dir)
    odd["DATASET"]["DICT_BATCH_SIZE"] = 3  # one SCST image: it runs whole on every rank
    trainer_module.host_local_refusal(ConfigNode(odd), 2)


@pytest.mark.parametrize("loader", ["native", "grain"])
def test_loader_parts_make_the_global_batches(loader):
    """``part = (r, 2)`` of either loader (the grain one unsharded, as a
    host-local rank builds it): each rank reads its contiguous half of
    every global batch of the same shuffled order, the two halves in rank
    order make the global batch, and a batch the ranks do not divide (the
    ragged last one) comes whole to both."""
    from openviic_tpu_torch.data.grain_loader import GrainDataLoader
    from openviic_tpu_torch.data.instance import Instance
    from openviic_tpu_torch.data.loader import DataLoader

    dataset = [Instance(index=i, rows=np.full((i % 3 + 1, 2), i, np.float32))
               for i in range(7)]

    def batches(part):
        if loader == "grain":
            made = GrainDataLoader(dataset, 4, shuffle=True, seed=17, shard_index=0,
                                   shard_count=1, read_threads=1, part=part)
        else:
            made = DataLoader(dataset, 4, shuffle=True, seed=17, part=part)
        return [list(items["index"]) for items in made]

    whole, zero, one = batches(None), batches((0, 2)), batches((1, 2))
    assert [len(b) for b in whole] == [4, 3]
    assert [len(b) for b in zero] == [len(b) for b in one] == [2, 3]
    assert zero[0] + one[0] == whole[0] and zero[1] == one[1] == whole[1]


def test_host_local_trainer_loaders_take_their_parts(tmp_path, tiny_dataset_dir):
    """A trainer built in a host-local group (one gloo rank in this
    process) with either loader: its train loaders read their rank's part
    of each global batch (grain's streams unsharded, as JAX's single host
    reads them), the XE loader drops the ragged batch and the SCST loader
    keeps it; the eval loaders stay whole."""
    from openviic_tpu_torch.builders import build_trainer
    from openviic_tpu_torch.parallel import runtime

    runtime.initialize_distributed("cpu", backend="gloo",
                                   init_method=f"file://{tmp_path / 'group'}", world_size=1,
                                   rank=0, host_local=True)
    try:
        for loader in ("native", "grain"):
            cfg = local_config(tmp_path / loader, tiny_dataset_dir)
            cfg["DATASET"]["LOADER"] = loader
            tr = build_trainer(ConfigNode(cfg), device="cpu")
            assert tr.mesh.size == 1 and runtime.host_local()
            assert tr.train_dataloader.part == tr.train_dict_dataloader.part == (0, 1)
            assert tr.train_dataloader.drop_last and not tr.train_dict_dataloader.drop_last
            for eval_loader in (tr.val_dataloader, tr.test_dataloader, tr.val_dict_dataloader):
                assert eval_loader.part is None
            if loader == "grain":
                assert all((dl.shard_index, dl.shard_count) == (0, 1)
                           for dl in (tr.train_dataloader, tr.train_dict_dataloader))
    finally:
        runtime.shutdown()
    assert not runtime.host_local()
