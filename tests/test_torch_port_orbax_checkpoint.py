"""The port's asynchronous, collective checkpoint backend
(``openviic_tpu_torch/training/orbax_backend.py``, ``CHECKPOINT_BACKEND:
orbax``, written through ``torch.distributed.checkpoint``) on the CPU:
JAX's two tests (``tests/test_orbax_checkpoint.py``) on the port's
trainer, a resume from ``last_model.orbax`` bit for bit, the staging
swap, optimizer steps taken during the background write, its errors, the refusal of a directory the JAX
package's Orbax backend wrote, serving from ``best_model.orbax``, and one
spawn of two gloo ranks for the collective contract."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from openviic_tpu_torch.builders import build_trainer
from openviic_tpu_torch.config import ConfigNode
from openviic_tpu_torch.parallel import launch
from openviic_tpu_torch.serving import CaptioningPipeline
from openviic_tpu_torch.training import checkpoint as ckpt
from openviic_tpu_torch.training import orbax_backend
from tests.test_torch_port_support import make_features
from tests.test_torch_port_trainer import config_dict
from tests.torch_port_backend_workers import orbax_rank


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def orbax_config(tmp, root, **training) -> ConfigNode:
    cfg = config_dict(tmp, root, CHECKPOINT_BACKEND="orbax", **training)
    return ConfigNode(cfg)


def params_of(tr) -> dict:
    return {k: v.detach().clone() for k, v in tr.model.state_dict().items()}


def assert_states_equal(a, b) -> None:
    pa, pb = params_of(a), params_of(b)
    assert pa.keys() == pb.keys()
    for k in pa:
        torch.testing.assert_close(pa[k], pb[k], rtol=0, atol=0, msg=k)
    sa, sb = a.state["optimizer"].state_dict(), b.state["optimizer"].state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            torch.testing.assert_close(v, sb["state"][i][k], rtol=0, atol=0)
    assert int(a.state["step"]) == int(b.state["step"])
    assert torch.equal(a.state["generator"].get_state(), b.state["generator"].get_state())


# -- JAX's two tests, on the port's trainer -------------------------------
def test_orbax_roundtrip_and_phase_switch(tmp_path, tiny_dataset_dir):
    cfg = orbax_config(tmp_path, tiny_dataset_dir)
    tr = build_trainer(cfg, device="cpu")
    assert isinstance(tr._ckpt_io, orbax_backend.OrbaxBackend)
    tr.train()
    saved_numpy = np.random.get_state()[1].copy()
    tr.save_checkpoint({"val_loss": 1.5, "best_val_score": 0.2, "patience": 1,
                        "use_rl": False})
    tr._ckpt_io.wait()
    last = os.path.join(tr.checkpoint_path, tr._ckpt_io.LAST_NAME)
    assert os.path.isdir(last) and os.path.isfile(os.path.join(last, ".metadata"))
    assert not os.path.exists(last + ".staging")

    # a fresh trainer restores the weights, Adam, the extras and numpy's RNG
    tr2 = build_trainer(cfg, device="cpu")
    np.random.seed(123)
    loaded = tr2.load_checkpoint(last)
    assert loaded["use_rl"] is False and loaded["patience"] == 1
    assert abs(loaded["val_loss"] - 1.5) < 1e-9
    assert_states_equal(tr2, tr)
    assert np.array_equal(np.random.get_state()[1], saved_numpy)

    # an SCST save loads into an XE-phase trainer, and an XE one into SCST
    tr._ensure_scst()
    tr.save_checkpoint({"val_loss": 1.0, "best_val_score": 0.3, "patience": 0,
                        "use_rl": True})
    tr._ckpt_io.wait()
    tr4 = build_trainer(cfg, device="cpu")
    loaded4 = tr4.load_checkpoint(last)
    assert loaded4 is not None and loaded4["use_rl"] is True
    tr4._ensure_scst(reset_opt=False)
    assert np.isfinite(tr4.train_scst())
    tr4._ckpt_io = ckpt.get_backend("orbax")
    tr4.save_checkpoint({"val_loss": 0.5, "best_val_score": 0.4, "patience": 0,
                         "use_rl": False})
    tr4._ckpt_io.wait()
    tr5 = build_trainer(cfg, device="cpu")
    tr5._ensure_scst()
    tr5.load_checkpoint(last)  # an RL-phase trainer takes an XE save's weights and Adam
    assert tr5.state["scheduler"] is not None and np.isfinite(tr5.train())


def test_orbax_best_copy_and_step_continuity(tmp_path, tiny_dataset_dir):
    cfg = orbax_config(tmp_path, tiny_dataset_dir)
    tr = build_trainer(cfg, device="cpu")
    tr.train()
    step_after_train = int(tr.state["step"])
    assert step_after_train > 0
    tr.save_checkpoint({"val_loss": 1.0, "best_val_score": 0.5, "patience": 0,
                        "use_rl": False})
    io = tr._ckpt_io
    last = os.path.join(tr.checkpoint_path, io.LAST_NAME)
    best = os.path.join(tr.checkpoint_path, io.BEST_NAME)
    io.copy(last, best)
    assert io.exists(best)
    tr2 = build_trainer(cfg, device="cpu")
    tr2.load_checkpoint(best)
    assert int(tr2.state["step"]) == step_after_train
    tr2.train()
    assert int(tr2.state["step"]) > step_after_train


# -- the port's own contracts ---------------------------------------------
def test_resume_from_last_model_orbax_is_bit_identical(tmp_path, tiny_dataset_dir):
    """Two epochs uninterrupted against one, then a new trainer resuming
    from ``last_model.orbax`` for the second: parameters, Adam, step,
    generator and loader counters equal bit for bit."""
    u = build_trainer(orbax_config(tmp_path / "u", tiny_dataset_dir), device="cpu")
    u.start(max_epochs=2)
    r_cfg = orbax_config(tmp_path / "r", tiny_dataset_dir)
    build_trainer(r_cfg, device="cpu").start(max_epochs=1)
    r = build_trainer(r_cfg, device="cpu")
    r.start(max_epochs=1)
    assert r.epoch == u.epoch
    assert_states_equal(r, u)
    assert (r.train_dataloader.epoch, r.train_dict_dataloader.epoch) == (
        u.train_dataloader.epoch, u.train_dict_dataloader.epoch)
    names = sorted(os.listdir(r.checkpoint_path))
    assert {"last_model.orbax", "best_model.orbax"} <= set(names)
    assert not any(n.endswith(".staging") for n in names)


def small_state(seed: int = 0):
    torch.manual_seed(seed)
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    model(torch.randn(2, 4)).sum().backward()
    opt.step()
    return model, {"optimizer": opt, "scheduler": None, "step": seed,
                   "generator": torch.Generator().manual_seed(seed)}


def test_staging_adopted_when_finished_never_when_not(tmp_path):
    """A save whose swap never ran (a crash after the write): a load of the
    missing ``path`` adopts the staging directory when its ``.metadata``
    is there, and not otherwise (None, the directory left alone)."""
    model, state = small_state(1)
    path = str(tmp_path / "last_model.orbax")
    be = orbax_backend.OrbaxBackend()
    be.save_checkpoint(path, model, state, {"epoch": 9})
    be._future.result()
    be._future = be._pending_swap = None  # the process died before the swap
    assert not os.path.exists(path) and be.exists(path)
    loaded = orbax_backend.OrbaxBackend().load_checkpoint(path)
    assert loaded["epoch"] == 9 and os.path.isdir(path)
    assert not os.path.exists(path + ".staging")
    torch.testing.assert_close(loaded["model"]["weight"], model.weight.detach(), rtol=0, atol=0)

    unfinished = str(tmp_path / "other.orbax")
    be.save_checkpoint(unfinished, model, state, {"epoch": 10})
    be._future.result()
    be._future = be._pending_swap = None
    os.remove(os.path.join(unfinished + ".staging", ".metadata"))  # the write never finished
    assert orbax_backend.OrbaxBackend().load_checkpoint(unfinished) is None
    assert os.path.isdir(unfinished + ".staging") and not os.path.exists(unfinished)


def test_steps_taken_during_the_background_write_do_not_reach_it(tmp_path, monkeypatch):
    """Training goes on while the checkpoint is written: the write is held
    back until the optimizer has taken three more steps in place, and the
    checkpoint read back equals, bit for bit, the weights, Adam's moments
    and the generator copied at the save."""
    import threading

    from torch.distributed.checkpoint import FileSystemWriter

    model, state = small_state(3)
    opt = state["optimizer"]
    want = {k: v.detach().clone() for k, v in model.state_dict().items()}
    want_moments = {i: {k: v.clone() for k, v in entry.items() if torch.is_tensor(v)}
                    for i, entry in opt.state_dict()["state"].items()}
    want_generator = state["generator"].get_state().clone()
    release, started = threading.Event(), threading.Event()
    real_write = FileSystemWriter.write_data

    def held_write(self, plan, planner):
        started.set()
        assert release.wait(30), "the write was never released"
        return real_write(self, plan, planner)

    monkeypatch.setattr(FileSystemWriter, "write_data", held_write)
    path = str(tmp_path / "last_model.orbax")
    be = orbax_backend.OrbaxBackend()
    be.save_checkpoint(path, model, state, {"epoch": 1})
    assert started.wait(30) and not be._future.done()  # the write is under way
    for _ in range(3):
        opt.zero_grad()
        model(torch.randn(2, 4)).square().sum().backward()
        opt.step()
    state["generator"].manual_seed(99)
    assert not torch.equal(model.weight.detach(), want["weight"])
    release.set()
    be.wait()
    monkeypatch.undo()
    loaded = orbax_backend.OrbaxBackend().load_checkpoint(path)
    assert loaded["model"].keys() == want.keys()
    for k, v in want.items():
        torch.testing.assert_close(loaded["model"][k], v, rtol=0, atol=0, msg=k)
    for i, entry in want_moments.items():
        for k, v in entry.items():
            torch.testing.assert_close(loaded["optimizer"]["state"][i][k], v, rtol=0, atol=0)
    assert torch.equal(loaded["generator"], want_generator)


def test_a_failed_background_write_reaches_wait_and_keeps_the_last_checkpoint(
        tmp_path, monkeypatch):
    """The write's error (DCP's ``CheckpointException``) comes out of the
    next ``wait()``, once; the previous checkpoint stays in place."""
    from torch.distributed.checkpoint import FileSystemWriter
    from torch.distributed.checkpoint.api import CheckpointException

    model, state = small_state(2)
    path = str(tmp_path / "last_model.orbax")
    be = orbax_backend.OrbaxBackend()
    be.save_checkpoint(path, model, state, {"epoch": 1})
    be.wait()

    def broken(self, plan, planner):
        raise OSError("disk full")

    monkeypatch.setattr(FileSystemWriter, "write_data", broken)
    be.save_checkpoint(path, model, state, {"epoch": 2})  # returns; the write fails behind it
    with pytest.raises(CheckpointException, match="disk full"):
        be.wait()
    be.wait()  # the failure is reported once, and nothing is swapped in
    monkeypatch.undo()
    assert orbax_backend.OrbaxBackend().load_checkpoint(path)["epoch"] == 1


def test_a_jax_orbax_directory_is_refused_before_anything_is_restored(tmp_path):
    """A ``last_model.orbax`` that the JAX package's Orbax backend wrote, a
    native checkpoint file's directory and an empty one raise
    ``ValueError``; numpy's global state is untouched."""
    from openviic_tpu.training.orbax_backend import OrbaxBackend as JaxOrbaxBackend

    jax_path = str(tmp_path / "jax" / "last_model.orbax")
    os.makedirs(os.path.dirname(jax_path))
    jax_be = JaxOrbaxBackend()
    jax_be.save_checkpoint(jax_path, {"params": {"w": np.ones((2, 3), np.float32)},
                                      "opt_state": (np.zeros(3, np.float32),), "step": 3,
                                      "rng": jax.random.PRNGKey(0)}, {"epoch": 1})
    jax_be.wait()
    assert os.path.isdir(jax_path)
    empty = tmp_path / "empty.orbax"
    empty.mkdir()
    fake = tmp_path / "fake.orbax"
    fake.mkdir()
    model, state = small_state(3)
    ckpt.save_checkpoint(str(fake / ".metadata"), model, state, {})
    np.random.seed(5)
    before = np.random.get_state()[1].copy()
    for path in (jax_path, str(empty), str(fake)):
        with pytest.raises(ValueError, match="not a checkpoint of openviic_tpu_torch"):
            orbax_backend.OrbaxBackend().load_checkpoint(path)
    assert np.array_equal(np.random.get_state()[1], before)


def test_pipeline_from_best_model_orbax_equals_the_native_checkpoint(tmp_path,
                                                                     tiny_dataset_dir):
    """``CaptioningPipeline(device="cpu")`` under ``CHECKPOINT_BACKEND:
    orbax`` reads ``best_model.orbax`` and captions with the tokens it
    gives from the native ``best_model.ckpt`` of the same weights."""
    cfg = orbax_config(tmp_path, tiny_dataset_dir)
    tr = build_trainer(cfg, device="cpu")
    tr.train()
    tr.save_checkpoint({"val_loss": 1.0, "best_val_score": 0.5, "patience": 0,
                        "use_rl": False})
    io = tr._ckpt_io
    io.copy(os.path.join(tr.checkpoint_path, io.LAST_NAME),
            os.path.join(tr.checkpoint_path, io.BEST_NAME))
    ckpt.save_checkpoint(os.path.join(tr.checkpoint_path, ckpt.BEST_NAME), tr.model, tr.state,
                         {"epoch": 0})
    native = ConfigNode(config_dict(tmp_path, tiny_dataset_dir))
    images = [{"region_features": f} for f in make_features(3, seed=8)]
    got = CaptioningPipeline(cfg, use_bf16=False, device="cpu").caption_features(
        images, return_ids=True)
    want = CaptioningPipeline(native, use_bf16=False, device="cpu").caption_features(
        images, return_ids=True)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


def test_two_ranks_save_copy_and_load_collectively(tmp_path):
    """One spawn of two gloo ranks (``parallel.launch.spawn``): a save, the
    best copy and a load on both, then a finished staging directory
    adopted; every rank passes the same named barriers in the same order,
    only rank 0 swaps a staging directory in (DCP's own renames of its
    files aside), and both load what was saved."""
    launch.spawn(orbax_rank, ["cpu", "cpu"], args=(str(tmp_path),))
    ranks = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    zero, one = ranks
    assert zero["barriers"] == one["barriers"] and len(zero["barriers"]) >= 6
    names = [b[0] for b in zero["barriers"]]
    assert all(b == [n, n] for b, n in zip(zero["barriers"], names))
    assert [n.split("_", 2)[2].rsplit("_", 1)[0] for n in names][:5] == [
        "staging_clean", "write_done", "swap_done", "copy_done", "staging_clean"]
    swaps = [[r for r in rank["renames"] if r[0].endswith(".staging")] for rank in ranks]
    assert swaps[0] == [["last_model.orbax.staging", "last_model.orbax"],
                        ["crash.orbax.staging", "crash.orbax"]]
    assert swaps[1] == []
    for r in ranks:
        assert r["equal"] and r["epoch"] == 3 and r["adopted_epoch"] == 4
        assert ".metadata" in r["files"]
